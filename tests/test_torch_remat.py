"""Port layer remat (``model.remat`` -> ``ops/remat.remat_module``).

- With dropout 0.1 and the same seed, remat on and off give bit-identical
  losses and gradients on the CPU, pre-LN and post-LN, for every encoder
  and decoder leaf; every layer's forward runs again in the backward. This
  is the test that catches a recompute drawing other dropout bits: a plain
  ``torch.utils.checkpoint`` wrap, which restores only the default
  generators, fails it (shown here too).
- Under the train step's ``functional_call`` (f32 masters cast to bf16)
  remat recomputes on the cast copies, bit-identically.
- With remat on and dropout off, one train step matches JAX's (built with
  ``remat=True``) at ``tests/test_torch_train.py``'s f32 tolerances: loss
  1e-5, grad norm 1e-4, first moments (the clipped gradients) 1e-4 of each
  leaf's largest value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu.config import get_config as jax_get_config  # noqa: E402
from speech_tranformer_pytorch_tpu.data.pipeline import (  # noqa: E402
    AudioBatch as JaxAudioBatch, make_audio_train_step as jax_audio_step,
    make_preprocess_fn as jax_preprocess)
from speech_tranformer_pytorch_tpu import train as jtrain  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.config import get_config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.convert import (  # noqa: E402
    adam_state_from_jax, params_from_jax)
from speech_tranformer_pytorch_tpu_torch.data.pipeline import (  # noqa: E402
    AudioBatch, make_audio_train_step, make_preprocess_fn)
from speech_tranformer_pytorch_tpu_torch.data.synthetic import (  # noqa: E402
    make_utterances, pad_targets)
from speech_tranformer_pytorch_tpu_torch.kernels import flash_attention as flash  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.ops import remat as remat_mod  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.train import (  # noqa: E402
    create_train_state, loss_and_grads)

NARROW = {"model.num_encoder_layers": 2, "model.num_decoder_layers": 2,
          "model.d_model": 64, "model.num_heads": 2, "model.d_ff": 128,
          "model.subsample_channels": 8}


def _arrays():
    audio, lens = make_utterances(3, min_seconds=0.7, max_seconds=1.3, seed=11)
    rng = np.random.default_rng(12)
    targets = [rng.integers(4, 64, size=n).tolist() for n in (6, 3, 9)]
    tin, tout, tlens = pad_targets(targets, 16)
    return dict(audio=audio, sample_lens=lens, targets_in=tin, targets_out=tout,
                target_lens=tlens, valid=np.ones(3, bool))


def _features(cfg):
    batch = AudioBatch(**{k: torch.from_numpy(v) for k, v in _arrays().items()})
    return make_preprocess_fn(cfg.features)(batch, "cpu")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _grads(over, remat, monkeypatch=None):
    cfg = get_config("tiny", **NARROW, **over, **{"model.remat": remat})
    state = create_train_state(cfg, device="cpu", seed=2)
    calls = [0]
    real = flash.flash_attention_reference

    def spy(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    if monkeypatch is not None:
        monkeypatch.setattr(flash, "flash_attention_reference", spy)
    grads, m = loss_and_grads(cfg, state, _features(cfg), 7)
    return grads, m["loss"], calls[0]


@pytest.mark.parametrize("normalize_before", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_is_bit_identical_with_dropout(normalize_before, dtype, monkeypatch):
    over = {"model.dropout_rate": 0.1, "model.normalize_before": normalize_before,
            "model.dtype": dtype}
    g_off, loss_off, fwd_off = _grads(over, False, monkeypatch)
    g_on, loss_on, fwd_on = _grads(over, True, monkeypatch)
    assert torch.equal(loss_on, loss_off)
    assert set(g_on) == set(g_off) and any(k.startswith("encoder.layers") for k in g_on)
    for k in g_off:
        assert torch.equal(g_on[k], g_off[k]), k
    layers = 2 + 2 * 2            # encoder self, decoder self and cross
    assert (fwd_off, fwd_on) == (layers, 2 * layers)


def test_plain_checkpoint_draws_other_bits(monkeypatch):
    """The trap: checkpointing without the generator snapshot recomputes
    with the generator where the forward left it, so other masks."""
    over = {"model.dropout_rate": 0.1}
    g_off, _, _ = _grads(over, False)

    def naive(fn, *args, generator=None):
        return torch.utils.checkpoint.checkpoint(
            lambda *a: fn(*a, generator=generator), *args, use_reentrant=False)

    monkeypatch.setattr(remat_mod, "remat", naive)
    g_naive, _, _ = _grads(over, True)
    assert not all(torch.equal(g_naive[k], g_off[k]) for k in g_off)


def test_remat_off_under_no_grad():
    cfg = get_config("tiny", **NARROW, **{"model.remat": True})
    state = create_train_state(cfg, device="cpu", seed=2)
    batch = _features(cfg)
    with torch.no_grad():
        a = state.model(batch.feats, batch.frame_lens, batch.targets_in, batch.target_lens)
    b = state.model.eval()(batch.feats, batch.frame_lens, batch.targets_in,
                           batch.target_lens)
    assert torch.equal(a, b.detach())


def test_remat_step_matches_jax():
    over = dict(NARROW, **{"model.dropout_rate": 0.0, "model.remat": True,
                           "model.dtype": "float32", "train.moment_dtype": "float32"})
    jcfg, cfg = jax_get_config("tiny", **over), get_config("tiny", **over)
    arrays = _arrays()
    jbatch = JaxAudioBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    with pytest.MonkeyPatch.context() as mp:   # one compile, not one per init op
        mp.setattr(jtrain, "init_params", jax.jit(jtrain.init_params, static_argnums=0))
        jstate = jtrain.create_train_state(jcfg, jax.random.PRNGKey(3),
                                           jax_preprocess(jcfg.features)(jbatch))
    params0 = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg.model)
    opt0 = adam_state_from_jax(jstate.opt_state, cfg.model)
    new_jstate, jm = jax_audio_step(jcfg, donate=False)(jstate, jbatch, jax.random.PRNGKey(4))
    state = create_train_state(cfg, device="cpu", params=params0, opt=opt0)
    batch = AudioBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    state, m = make_audio_train_step(cfg)(state, batch)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    want = params_from_jax(new_jstate.opt_state[1][0].mu, cfg.model)
    top = max(float(v.abs().max()) for v in want.values())
    for k, w in want.items():
        scale = top if k.endswith("cross_attn.k.bias") else max(float(w.abs().max()), 1e-30)
        assert float((state.opt.mu[k] - w).abs().max()) <= 1e-4 * scale, k
