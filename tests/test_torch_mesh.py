"""The port's mesh and sharding rules against the JAX package's
``parallel/mesh.py`` and ``parallel/sharding.py``.

- ``mesh_shape`` / ``make_mesh`` / ``make_mesh_auto``: the model axis must
  divide the ranks; ``auto`` falls back to no mesh (with JAX's warning)
  only in a single-rank launch, and a one-rank mesh is a real mesh.
- ``param_spec`` on every parameter of the ``tiny``, ``base`` and
  ``sharded`` trees, in both JAX layouts (per-layer and scanned), against
  JAX's ``param_spec`` on the leaf the port's name maps to
  (``convert._entries``), translated to the port's [out, in] layout.
- ``shard_params``: model rank m's shard of every leaf equals the block
  JAX's ``param_shardings`` puts on ``mesh.devices[d, m]`` of a (2, 4)
  mesh, for fused and unfused q/k/v and a tied and an untied output
  projection; ``merge_shards`` of the shards gives the leaf back.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu_torch.config import MeshConfig, get_config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.convert import (  # noqa: E402
    _entries, _to_port_layout, params_from_jax)
from speech_tranformer_pytorch_tpu_torch.parallel.mesh import (  # noqa: E402
    Mesh, make_mesh, make_mesh_auto, mesh_shape)
from speech_tranformer_pytorch_tpu_torch.parallel.sharding import (  # noqa: E402
    Shard, merge_shards, param_spec, shard_params)

SMALL = {"model.vocab_size": 32, "model.d_model": 64, "model.num_heads": 4,
         "model.d_ff": 128, "model.num_encoder_layers": 2, "model.num_decoder_layers": 2,
         "model.subsample_channels": 8, "model.dropout_rate": 0.0}


def test_mesh_shape_and_positions():
    assert mesh_shape(8, 4) == (2, 4) and mesh_shape(4, 1) == (4, 1)
    for world, tp in ((6, 4), (4, 0), (2, 4)):
        with pytest.raises(ValueError, match="must divide"):
            mesh_shape(world, tp)
    # rank r sits at (r // tp, r % tp)
    m = Mesh(2, 4, 6, torch.device("cpu"), None, None, [4, 5, 6, 7])
    assert (m.data_index, m.model_index, m.world, m.is_main) == (1, 2, 8, False)
    assert m.shape == {"data": 2, "model": 4}


def test_make_mesh_on_one_rank():
    import torch.distributed as dist

    try:
        with pytest.raises(ValueError, match="must divide"):
            make_mesh(model_axis_size=2, device="cpu")
        mesh = make_mesh(MeshConfig(model_axis=1), device="cpu")
        assert (mesh.dp, mesh.tp, mesh.rank) == (1, 1, 0)
        x = torch.ones(3)
        dist.all_reduce(x, group=mesh.model_group)      # a real one-rank group
        assert torch.equal(x, torch.ones(3))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_make_mesh_auto_falls_back_only_on_one_rank():
    with pytest.warns(UserWarning, match="falling back to the single-device path"):
        assert make_mesh_auto(MeshConfig(model_axis=4)) is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        import torch.distributed as dist
        try:
            assert make_mesh_auto(MeshConfig(model_axis=1), device="cpu").tp == 1
        finally:
            dist.destroy_process_group()


def _port_shard_of_jax_spec(spec, kind, shape):
    """The port ``Shard`` that JAX's PartitionSpec of a leaf means for the
    port's tensor of it (``convert._to_port_layout``'s layout)."""
    axes = [i for i, a in enumerate(spec) if a == "model"]
    if not axes:
        return None
    a = axes[0]
    if kind[0] == "dense":
        n_in = kind[1]
        if a < n_in:
            return Shard(1, int(np.prod(shape[:a], dtype=int)))
        return Shard(0, int(np.prod(shape[n_in:a], dtype=int)))
    if kind[0] == "bias":
        return Shard(0, int(np.prod(shape[:a], dtype=int)))
    return Shard(a)


def _jax_param_shapes(jcfg):
    import jax
    import jax.numpy as jnp

    from speech_tranformer_pytorch_tpu.data.pipeline import Batch
    from speech_tranformer_pytorch_tpu.train import init_params

    example = Batch(jnp.zeros((1, 64, jcfg.model.input_dim)), jnp.full((1,), 64, jnp.int32),
                    jnp.ones((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32),
                    jnp.full((1,), 4, jnp.int32))
    return jax.eval_shape(lambda k: init_params(jcfg, k, example),
                          jax.random.PRNGKey(0))["params"]


@pytest.mark.parametrize("scan", [False, True], ids=["per_layer", "scanned"])
@pytest.mark.parametrize("preset", ["tiny", "base", "sharded"])
def test_param_spec_matches_jax(preset, scan):
    from speech_tranformer_pytorch_tpu.config import get_config as jax_get_config
    from speech_tranformer_pytorch_tpu.parallel.sharding import param_spec as jax_spec

    over = {"model.scan_layers": scan}
    cfg, jcfg = get_config(preset, **over), jax_get_config(preset, **over)
    tree = _jax_param_shapes(jcfg)
    sharded = 0
    for name, path, kind, shape, layer in _entries(cfg.model):
        leaf = tree
        for key in path:
            leaf = leaf[key]
        spec = tuple(jax_spec("params/" + "/".join(path), leaf))
        if layer is not None:          # the scanned layer axis stays whole
            assert leaf.ndim == len(shape) + 1 and (not spec or spec[0] is None), name
            spec = spec[1:]
        want = _port_shard_of_jax_spec(spec, kind, shape)
        assert param_spec(name) == want, (name, spec)
        sharded += want is not None
    assert sharded > 0


@pytest.mark.parametrize("fused,tied", [(True, True), (False, False)],
                         ids=["fused_tied", "unfused_untied"])
def test_shard_params_match_jax_device_shards(fused, tied):
    import jax
    import jax.numpy as jnp

    from speech_tranformer_pytorch_tpu.config import get_config as jax_get_config
    from speech_tranformer_pytorch_tpu.data.pipeline import Batch
    from speech_tranformer_pytorch_tpu.parallel import make_mesh as jax_make_mesh
    from speech_tranformer_pytorch_tpu.parallel.sharding import param_shardings
    from speech_tranformer_pytorch_tpu.train import init_params

    over = dict(SMALL, **{"model.fused_qkv": fused, "model.share_embedding": tied})
    cfg, jcfg = get_config("tiny", **over), jax_get_config("tiny", **over)
    example = Batch(jnp.zeros((1, 64, 80)), jnp.full((1,), 64, jnp.int32),
                    jnp.ones((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32),
                    jnp.full((1,), 4, jnp.int32))
    params = jax.jit(lambda k: init_params(jcfg, k, example))(jax.random.PRNGKey(1))
    whole = params_from_jax(jax.tree.map(np.asarray, params), cfg.model)
    mesh = jax_make_mesh(model_axis_size=4)                  # (2, 4)
    placed = jax.device_put(params, param_shardings(mesh, params))["params"]
    position = {dev.id: (d, m) for (d, m), dev in np.ndenumerate(mesh.devices)}
    ports = [shard_params(whole, 4, m) for m in range(4)]
    for name, path, kind, shape, _ in _entries(cfg.model):
        arr = placed
        for key in path:
            arr = arr[key]
        for shard in arr.addressable_shards:
            _, m = position[shard.device.id]
            got = ports[m][name]
            want = _to_port_layout(np.asarray(shard.data), kind)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{name} m={m}")
        back = merge_shards([p[name] for p in ports], param_spec(name))
        assert torch.equal(back, whole[name]), name
