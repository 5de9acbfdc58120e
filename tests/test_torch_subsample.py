"""``model.subsample_impl`` in the port against the JAX package.

The JAX package has three forms of the conv subsampler on one parameter
tree (``Conv_0``/``Conv_1`` kernels and biases): XLA's conv (``'conv'``),
strided patches and one matmul (``'im2col'``, ``_PatchConv``), and the
conv for the first layer with even/odd phases and one matmul for the
second (``'phase'``, ``_PhaseConv``). The port builds one
``Conv2dSubsampling`` for all three (``'conv'`` is held by
``tests/test_torch_model.py``). A JAX model built with each other setting,
its weights carried by ``convert.params_from_jax``, gives the port's
encoder memory and teacher-forced logits at valid target positions within
the model parity tolerance of ``tests/test_torch_model.py`` (1e-4; the
forms differ in summation order only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu.config import get_config as jax_get_config  # noqa: E402
from speech_tranformer_pytorch_tpu.models import SpeechTransformer as JaxModel  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.config import get_config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.convert import params_from_jax  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.models import SpeechTransformer  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["im2col", "phase"])
def test_subsample_impl_matches_jax(impl):
    over = {"model.subsample_impl": impl, "model.num_encoder_layers": 1,
            "model.num_decoder_layers": 1}
    jcfg, cfg = jax_get_config("tiny", **over), get_config("tiny", **over)
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((2, 101, 80)).astype(np.float32)
    frame_lens = np.array([101, 64], np.int32)
    targets = rng.integers(3, cfg.model.vocab_size, size=(2, 6)).astype(np.int32)
    tgt_lens = np.array([6, 3], np.int32)
    args = [jnp.asarray(x) for x in (feats, frame_lens, targets, tgt_lens)]
    jmodel = JaxModel(jcfg.model)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(7), *args)
    model = SpeechTransformer(cfg.model).eval()
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, variables), cfg.model))
    jmem, jlens = jax.jit(lambda v, f, n: jmodel.apply(v, f, n, method=JaxModel.encode))(
        variables, *args[:2])
    jlogits = np.asarray(jax.jit(jmodel.apply)(variables, *args))
    with torch.no_grad():
        t = [torch.from_numpy(x) for x in (feats, frame_lens, targets, tgt_lens)]
        mem, lens = model.encode(*t[:2])
        logits = model(*t).numpy()
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    np.testing.assert_allclose(mem.numpy(), np.asarray(jmem), **TOL)
    for b, n in enumerate(tgt_lens):
        np.testing.assert_allclose(logits[b, :n], jlogits[b, :n], **TOL)
