"""The port's sharded audio train step against the JAX package's
``make_sharded_audio_train_step`` on a (data 2, model 2) mesh.

Both start from the same flax init of the tiny preset (dropout 0, f32
compute and moments), converted with ``convert.params_from_jax`` /
``adam_state_from_jax``, and take two steps on the same global batch of
four seeded int16 utterances whose targets give the two data ranks
different token counts (so a mean over ranks would differ from the global
token-weighted mean). The port runs 4 gloo ranks (``parallel.mesh.
spawn_ranks``, one spawn for the module; the ranks import nothing of JAX);
JAX runs the fake 8-device CPU mesh. Held, for ``attention_impl`` auto and
ring, against JAX's sharded step and against the port's own single-device
step on the global batch: loss, tokens and accuracy within 1e-5 relative,
the grad norm within 1e-5 relative, the first Adam moment (the
clip-scaled gradients) of every gathered leaf within 1e-4 of its largest
value (the cross-attention key biases, whose exact gradient is zero,
against the largest of all leaves), and each leaf's two-step update
(params minus the start) within 5e-3 of its L2 norm, the key-bias
elements left out (see ``_key_bias``). JAX's own auto and ring steps
disagree on this batch by more than these limits, through one ReLU unit
at its kink (``test_sharded_step_matches_jax``): the port's auto step may
differ from JAX's auto step by as much more as JAX's ring step does, and
nowhere else. ``gather_params ∘ shard_params`` is the identity on every
rank.
``train.master_weights`` with a mesh raises, as in JAX. With dropout 0.1
on a (1, 4) mesh, where each rank keeps its block of the whole tensor's
dropout bits, two steps equal the single-device steps with dropout (the
same bits; 1e-5 relative)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu_torch.config import get_config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.convert import params_from_jax  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data.pipeline import (  # noqa: E402
    AudioBatch, make_audio_train_step)
from speech_tranformer_pytorch_tpu_torch.data.synthetic import (  # noqa: E402
    make_utterances, pad_targets)
from speech_tranformer_pytorch_tpu_torch.parallel.mesh import (  # noqa: E402
    Mesh, make_mesh, spawn_ranks)
from speech_tranformer_pytorch_tpu_torch.parallel.sharding import (  # noqa: E402
    data_rows, gather_adam_state, gather_params, make_sharded_audio_train_step,
    shard_params)
from speech_tranformer_pytorch_tpu_torch.train import create_train_state  # noqa: E402

OVER = {"model.dropout_rate": 0.0, "model.num_encoder_layers": 2,
        "model.num_decoder_layers": 2, "train.moment_dtype": "float32",
        "mesh.model_axis": 2}
IMPLS = ("auto", "ring")
DROPOUT = {"model.dropout_rate": 0.1, "model.attention_dropout_rate": 0.1,
           "mesh.model_axis": 4}
STEPS = 2
FIELDS = ("audio", "sample_lens", "targets_in", "targets_out", "target_lens", "valid")


def _cfg(impl, get=get_config):
    return get("tiny", **dict(OVER, **{"model.attention_impl": impl}))


def _arrays():
    audio, lens = make_utterances(4, min_seconds=0.7, max_seconds=1.4, seed=21)
    rng = np.random.default_rng(22)
    targets = [rng.integers(4, 64, size=n).tolist() for n in (2, 3, 11, 9)]
    tin, tout, tlens = pad_targets(targets, 16)
    return dict(audio=audio, sample_lens=lens, targets_in=tin, targets_out=tout,
                target_lens=tlens, valid=np.ones(4, bool))


def _batch(arrays):
    return AudioBatch(**{k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()})


def _steps(step, state, batch):
    out = []
    for _ in range(STEPS):
        state, m = step(state, batch, 1)
        out.append({k: float(v) for k, v in m.items()})
    return state, out


def _train_rank(rank, arrays, params0, opt0):
    torch.set_num_threads(1)
    out = {}
    for impl in IMPLS:
        cfg = _cfg(impl)
        mesh = make_mesh(cfg.mesh, device="cpu")
        state = create_train_state(cfg, device="cpu", params=params0, opt=opt0, mesh=mesh)
        local = {k: v.detach() for k, v in state.model.state_dict().items()}
        identity = all(torch.equal(v, params0[k])
                       for k, v in gather_params(local, mesh).items())
        batch = _batch(arrays)
        local_batch = AudioBatch(*(data_rows(getattr(batch, f), mesh) for f in FIELDS))
        state, metrics = _steps(make_sharded_audio_train_step(cfg, mesh), state,
                                local_batch)
        params = gather_params({k: v.detach() for k, v in state.params.items()}, mesh)
        mu = gather_adam_state(state.opt, mesh).mu
        out[impl] = dict(identity=identity, metrics=metrics,
                         rows=int(local_batch.target_lens.sum()),
                         params=params if rank == 0 else None,
                         mu=mu if rank == 0 else None)
    cfg = get_config("tiny", **dict(OVER, **DROPOUT))
    mesh = make_mesh(cfg.mesh, device="cpu")
    state = create_train_state(cfg, device="cpu", params=params0, opt=opt0, mesh=mesh)
    out["dropout"] = _steps(make_sharded_audio_train_step(cfg, mesh), state,
                            _batch(arrays))[1]
    return out


@pytest.fixture(scope="module")
def runs():
    import jax
    import jax.numpy as jnp

    from speech_tranformer_pytorch_tpu.config import get_config as jax_get_config
    from speech_tranformer_pytorch_tpu.data.pipeline import (
        AudioBatch as JaxAudioBatch, make_preprocess_fn as jax_preprocess)
    from speech_tranformer_pytorch_tpu.parallel import make_mesh as jax_make_mesh
    from speech_tranformer_pytorch_tpu.parallel.sharding import (
        globalize_audio_batch, make_sharded_audio_train_step as jax_step,
        shard_train_state)
    from speech_tranformer_pytorch_tpu.train import create_train_state as jax_create
    from speech_tranformer_pytorch_tpu_torch.convert import adam_state_from_jax

    arrays = _arrays()
    jbatch = JaxAudioBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jcfg0 = _cfg("auto", jax_get_config)
    example = jax.jit(jax_preprocess(jcfg0.features))(jbatch)
    jstate0 = jax_create(jcfg0, jax.random.PRNGKey(3), example, sharded=True)
    cfg0 = _cfg("auto")
    params0 = params_from_jax(jax.tree.map(np.asarray, jstate0.params), cfg0.model)
    opt0 = adam_state_from_jax(jstate0.opt_state, cfg0.model)

    ranks = spawn_ranks(_train_rank, 4, arrays, params0, opt0)

    mesh = jax_make_mesh(model_axis_size=2, devices=jax.devices()[:4])
    gbatch = globalize_audio_batch(mesh, jbatch)
    want = {}
    for impl in IMPLS:
        jcfg = _cfg(impl, jax_get_config)
        state = shard_train_state(jstate0, mesh)
        step = jax_step(jcfg, mesh, donate=False)(state, gbatch)
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, gbatch, jax.random.PRNGKey(4))
            metrics.append({k: float(v) for k, v in m.items()})
        want[impl] = dict(metrics=metrics,
                          params=params_from_jax(jax.tree.map(np.asarray, state.params),
                                                 cfg0.model),
                          mu=adam_state_from_jax(state.opt_state, cfg0.model).mu)

    # A fresh optimizer state: the single-device step updates it in place.
    single, metrics = _steps(make_audio_train_step(cfg0), create_train_state(
        cfg0, device="cpu", params=params0,
        opt=adam_state_from_jax(jstate0.opt_state, cfg0.model)), _batch(arrays))
    want["single"] = dict(metrics=metrics,
                          params={k: v.detach() for k, v in single.params.items()},
                          mu=single.opt.mu)
    want["start"] = params0
    cfg = get_config("tiny", **dict(OVER, **DROPOUT))
    want["dropout"] = _steps(make_audio_train_step(cfg), create_train_state(
        cfg, device="cpu", params=params0,
        opt=adam_state_from_jax(jstate0.opt_state, cfg0.model)), _batch(arrays))[1]
    return ranks, want


def _key_bias(k, v):
    """The elements of ``v`` that are key biases: ``cross_attn.k.bias`` and
    the k third of a fused ``qkv.bias``. A key bias adds the same score to
    every key of a query, so its exact gradient is zero: its moments are
    round-off and its Adam updates the signs of round-off."""
    mask = torch.zeros(v.shape, dtype=torch.bool)
    if k.endswith("k.bias"):
        mask[:] = True
    elif k.endswith("qkv.bias"):
        d = v.shape[0] // 3
        mask[d:2 * d] = True
    return mask


def _check(got, want, start, spread=None):
    """``got`` against ``want`` at the limits of the module docstring.
    ``spread``: another JAX step on the same batch; where it differs from
    ``want``, ``got`` may differ from ``want`` by that much more."""
    for i, (m, w) in enumerate(zip(got["metrics"], want["metrics"])):
        for key in ("loss", "tokens", "accuracy", "lr", "audio_seconds"):
            assert m[key] == pytest.approx(w[key], rel=1e-5), key
        slack = 0.0 if spread is None else abs(spread["metrics"][i]["grad_norm"]
                                               - w["grad_norm"])
        assert abs(m["grad_norm"] - w["grad_norm"]) <= 1e-5 * w["grad_norm"] + slack, (
            i, m["grad_norm"], w["grad_norm"])
    top = max(float(v.abs().max()) for v in want["mu"].values())
    for k, w in want["mu"].items():
        scale = top if k.endswith("cross_attn.k.bias") else float(w.abs().max())
        err = (got["mu"][k].float() - w.float()).abs()
        if spread is not None:
            err = err - (spread["mu"][k].float() - w.float()).abs()
        assert float(err.max()) <= 1e-4 * scale, ("mu", k, float(err.max()), scale)
    for k, w in want["params"].items():
        keep = ~_key_bias(k, w)
        if not bool(keep.any()):
            continue
        step = (w - start[k])[keep]
        err = float(((got["params"][k] - start[k])[keep] - step).norm())
        slack = 0.0 if spread is None else float(
            ((spread["params"][k] - start[k])[keep] - step).norm())
        assert err <= 5e-3 * float(step.norm()) + slack, ("params", k, err,
                                                          float(step.norm()))


@pytest.mark.parametrize("impl", IMPLS)
def test_sharded_step_matches_jax(runs, impl):
    """The ring step directly against JAX's ring step. The auto step against
    JAX's auto step, with JAX's ring step as the spread: JAX's two routes
    compute the same function but round differently, and on this batch
    unit 179 of decoder layer 0's FFN has a pre-activation of 1.2e-6 at one
    valid token (median |h| 0.68), so the two JAX steps take its ReLU on
    either side. JAX's auto step differs from its ring step by 1.6% of the
    leaf's largest first moment in that unit's ``fc1`` row, and from there
    in 69 leaves by more than 1e-4, where the port's sharded and
    single-device steps and JAX's ring step agree to 1.3e-5."""
    ranks, want = runs
    spread = want["ring"] if impl == "auto" else None
    _check(ranks[0][impl], want[impl], want["start"], spread)


@pytest.mark.parametrize("impl", IMPLS)
def test_sharded_step_matches_single_device(runs, impl):
    ranks, want = runs
    _check(ranks[0][impl], want["single"], want["start"])


@pytest.mark.parametrize("impl", IMPLS)
def test_every_rank_agrees_and_token_counts_differ(runs, impl):
    ranks, _ = runs
    assert all(r[impl]["identity"] for r in ranks)
    assert all(r[impl]["metrics"] == ranks[0][impl]["metrics"] for r in ranks)
    # Data ranks (0 and 2) hold different token counts: the global mean is
    # not the mean of the ranks' means.
    assert ranks[0][impl]["rows"] != ranks[2][impl]["rows"]


def test_tensor_parallel_dropout_draws_the_single_device_bits(runs):
    ranks, want = runs
    for r in ranks:
        for m, w in zip(r["dropout"], want["dropout"]):
            for key in ("loss", "accuracy", "grad_norm"):
                assert m[key] == pytest.approx(w[key], rel=1e-5), key


def test_master_weights_with_a_mesh_raise():
    cfg = get_config("tiny", **dict(OVER, **{"train.master_weights": True,
                                             "train.fused_optimizer": True,
                                             "model.dtype": "bfloat16"}))
    mesh = Mesh(1, 1, 0, torch.device("cpu"), None, None, [0])
    with pytest.raises(ValueError, match="single-device"):
        create_train_state(cfg, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="single-device"):
        make_sharded_audio_train_step(cfg, mesh)


def test_shard_params_takes_each_head_group():
    """A fused qkv weight's rank-m shard holds heads m·H/tp… of each of q,
    k and v, not a contiguous third."""
    w = torch.arange(3 * 4 * 2 * 5, dtype=torch.float32).reshape(3 * 4 * 2, 5)
    parts = [shard_params({"encoder.layers.0.self_attn.qkv.weight": w}, 2, m)[
        "encoder.layers.0.self_attn.qkv.weight"] for m in range(2)]
    heads = w.reshape(3, 4, 2, 5)
    for m, p in enumerate(parts):
        assert torch.equal(p.reshape(3, 2, 2, 5), heads[:, 2 * m:2 * m + 2])
