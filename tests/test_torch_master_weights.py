"""Port ``train.master_weights`` against the classic scheme and against the
JAX package.

- The scheme only drops the per-step cast: the model computes on the same
  bf16 values and the gradients' boundary cast is exact, so over 5 steps
  the f32 master equals the classic f32 parameters bit for bit and the
  losses are equal (JAX ``tests/test_train.py:294-328``, on the port), with
  dropout on. A checkpoint carries the master.
- Against JAX's master-weights step (fused optimizer, dropout off, bf16)
  from the same weights through the converter: loss and grad norm at the
  bf16 tolerances of ``tests/test_torch_train.py`` (2e-2, 5e-2), the
  master within 2·lr plus an f32 ulp of JAX's and moved on every leaf, and
  the first moments (the step's gradients) within 5e-2 of JAX's in norm.
- The master variant's plain version against JAX's ``updm`` on random
  leaves, at ``tests/test_torch_fused_adam.py``'s tolerances (f32: rtol
  1e-6, atol 1e-7; bf16 moments and parameters within one bf16 ulp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu.config import get_config as jax_get_config  # noqa: E402
from speech_tranformer_pytorch_tpu.data.pipeline import (  # noqa: E402
    AudioBatch as JaxAudioBatch, make_audio_train_step as jax_audio_step,
    make_preprocess_fn as jax_preprocess)
from speech_tranformer_pytorch_tpu.ops.fused_adam import FusedAdam as JaxFusedAdam  # noqa: E402
from speech_tranformer_pytorch_tpu.ops.schedules import noam_schedule as jax_noam  # noqa: E402
from speech_tranformer_pytorch_tpu import train as jtrain  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.config import get_config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.convert import (  # noqa: E402
    adam_state_from_jax, params_from_jax)
from speech_tranformer_pytorch_tpu_torch.data.pipeline import (  # noqa: E402
    AudioBatch, make_audio_train_step)
from speech_tranformer_pytorch_tpu_torch.data.synthetic import (  # noqa: E402
    make_utterances, pad_targets)
from speech_tranformer_pytorch_tpu_torch.kernels.fused_adam import (  # noqa: E402
    adam_update_master_reference)
from speech_tranformer_pytorch_tpu_torch.ops.fused_adam import FusedAdam  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.ops.schedules import noam_schedule  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.train import create_train_state  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.utils.checkpoint import (  # noqa: E402
    Checkpointer, CheckpointState)

SMALL = {"model.num_encoder_layers": 2, "model.num_decoder_layers": 2,
         "model.d_model": 64, "model.num_heads": 2, "model.d_ff": 128,
         "model.subsample_channels": 8, "model.dtype": "bfloat16",
         "train.fused_optimizer": True}
MASTER = {"train.master_weights": True}


def _arrays():
    audio, lens = make_utterances(3, min_seconds=0.7, max_seconds=1.3, seed=11)
    rng = np.random.default_rng(12)
    targets = [rng.integers(4, 64, size=n).tolist() for n in (6, 3, 9)]
    tin, tout, tlens = pad_targets(targets, 16)
    return dict(audio=audio, sample_lens=lens, targets_in=tin, targets_out=tout,
                target_lens=tlens, valid=np.ones(3, bool))


def _batch():
    return AudioBatch(**{k: torch.from_numpy(v) for k, v in _arrays().items()})


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_master_equals_classic_f32_params_over_5_steps(tmp_path):
    classic = get_config("tiny", **SMALL)
    master = get_config("tiny", **SMALL, **MASTER).validate()
    batch = _batch()
    s_c = create_train_state(classic, device="cpu", seed=4)
    s_m = create_train_state(master, device="cpu", seed=4)
    assert all(p.dtype == torch.bfloat16 for p in s_m.params.values())
    assert all(w.dtype == torch.float32 for w in s_m.opt.master.values())
    assert s_c.opt.master is None
    step_c, step_m = make_audio_train_step(classic), make_audio_train_step(master)
    for i in range(5):
        s_c, m_c = step_c(s_c, batch, 9)
        s_m, m_m = step_m(s_m, batch, 9)
        assert torch.equal(m_c["loss"], m_m["loss"]), i
        assert torch.equal(m_c["grad_norm"], m_m["grad_norm"]), i
    for k, p in s_c.params.items():
        assert torch.equal(s_m.opt.master[k], p.detach()), k
        assert torch.equal(s_m.params[k].detach(), p.detach().to(torch.bfloat16)), k
        assert not torch.equal(p.detach(), create_train_state(
            classic, device="cpu", seed=4).params[k].detach()), k

    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(5, CheckpointState.of(s_m, 0, 5, "h"))
    _, r = ck.restore()
    assert all(torch.equal(r.opt.master[k], s_m.opt.master[k]) for k in s_m.opt.master)
    assert all(r.params[k].dtype == torch.bfloat16 for k in r.params)
    resumed = create_train_state(master, device="cpu", params=r.params, opt=r.opt)
    resumed.step = 5
    s_m, m1 = step_m(s_m, batch, 9)
    resumed, m2 = step_m(resumed, batch, 9)
    assert torch.equal(m1["loss"], m2["loss"])
    assert all(torch.equal(resumed.opt.master[k], s_m.opt.master[k]) for k in s_m.opt.master)


def test_master_weights_step_matches_jax():
    over = dict(SMALL, **MASTER, **{"model.dropout_rate": 0.0})
    jcfg, cfg = jax_get_config("tiny", **over).validate(), get_config("tiny", **over)
    arrays = _arrays()
    jbatch = JaxAudioBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    with pytest.MonkeyPatch.context() as mp:   # one compile, not one per init op
        mp.setattr(jtrain, "init_params", jax.jit(jtrain.init_params, static_argnums=0))
        jstate = jtrain.create_train_state(jcfg, jax.random.PRNGKey(3),
                                           jax_preprocess(jcfg.features)(jbatch))
    assert jstate.opt_state.master is not None
    params0 = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg.model)
    opt0 = adam_state_from_jax(jstate.opt_state, cfg.model)
    master0 = {k: v.clone() for k, v in opt0.master.items()}   # the step updates in place
    assert opt0.master is not None and all(
        torch.equal(opt0.master[k].to(torch.bfloat16), params0[k]) for k in params0)
    new_jstate, jm = jax_audio_step(jcfg, donate=False)(jstate, jbatch, jax.random.PRNGKey(4))

    state = create_train_state(cfg, device="cpu", params=params0, opt=opt0)
    state, m = make_audio_train_step(cfg)(state, _batch())
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=2e-2)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=5e-2)
    lr = float(m["lr"])
    want = params_from_jax(jax.tree.map(np.asarray, new_jstate.opt_state.master), cfg.model)
    for k, w in state.opt.master.items():
        tol = 2 * lr + np.finfo(np.float32).eps * want[k].abs()
        assert bool(((w - want[k]).abs() <= tol).all()), k
        assert not torch.equal(w, master0[k]), f"{k}: the master did not move"
        assert state.params[k].dtype == torch.bfloat16
        assert torch.equal(state.params[k].detach(), w.to(torch.bfloat16)), k
    # The first moments are 0.1·(clip scale)·g: the step's gradient vector,
    # whose norm is held at 5e-2 above, held as a whole at the same 5e-2.
    want_mu = adam_state_from_jax(new_jstate.opt_state, cfg.model).mu
    flat = lambda d: torch.cat([d[k].float().reshape(-1) for k in want_mu])
    mu, mu_j = flat(state.opt.mu), flat(want_mu)
    assert float((mu - mu_j).norm()) <= 5e-2 * float(mu_j.norm())


def _bf16_ulp(x):
    _, e = np.frexp(np.maximum(np.abs(x), np.finfo(np.float32).tiny))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip,wd", [(5.0, 0.0), (0.05, 0.01), (0.0, 0.0)])
def test_master_plain_version_matches_jax_updm(clip, wd, moment_dtype):
    rng = np.random.default_rng(1)
    shapes = {"w": (37, 129), "b": (129,), "e": (300,)}
    master = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: (rng.standard_normal(s) * (10.0 if len(s) == 1 else 0.1)).astype(np.float32)
             for k, s in shapes.items()}
    hyper = dict(b1=0.9, b2=0.98, eps=1e-9, grad_clip_norm=clip, weight_decay=wd,
                 moment_dtype=moment_dtype, master_weights=True)
    jopt = JaxFusedAdam(jax_noam(64, 100, 1.0), **hyper)
    opt = FusedAdam(noam_schedule(64, 100, 1.0), **hyper)
    jstate = jopt.init({k: jnp.asarray(v) for k, v in master.items()})
    jparams = {k: jnp.asarray(v, jnp.bfloat16) for k, v in master.items()}
    state = opt.init({k: torch.from_numpy(v) for k, v in master.items()})
    params = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in master.items()}
    for _ in range(3):
        jg = {k: jnp.asarray(v, jnp.bfloat16) for k, v in grads.items()}
        jparams, jstate = jopt.update_apply(jg, jstate, jparams)
        g = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in grads.items()}
        state = opt.update_apply(g, state, params)
    for k in shapes:
        np.testing.assert_allclose(state.master[k].numpy(), np.asarray(jstate.master[k]),
                                   rtol=1e-6, atol=1e-7)
        want_p = np.asarray(jparams[k], np.float32)
        assert np.all(np.abs(params[k].float().numpy() - want_p) <= _bf16_ulp(want_p)), k
        for name in ("mu", "nu"):
            got = getattr(state, name)[k].float().numpy()
            want = np.asarray(getattr(jstate, name)[k], np.float32)
            if moment_dtype == "float32":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
            else:
                assert np.all(np.abs(got - want) <= _bf16_ulp(want)), (name, k)


def test_master_reference_is_the_classic_update_rounded():
    g = torch.Generator().manual_seed(0)
    shapes = [(5, 7), (11,)]
    w0 = [torch.randn(s, generator=g) for s in shapes]
    gr = [torch.randn(s, generator=g).to(torch.bfloat16) for s in shapes]
    sc = torch.tensor([0.5, 1e-3, 10.0, 50.0])
    hyper = dict(b1=0.9, b2=0.98, eps=1e-9, weight_decay=0.01)
    from speech_tranformer_pytorch_tpu_torch.kernels.fused_adam import adam_update_reference
    p_c = [x.clone() for x in w0]
    mu_c, nu_c = [torch.zeros(s) for s in shapes], [torch.zeros(s) for s in shapes]
    adam_update_reference(p_c, [x.float() for x in gr], mu_c, nu_c, sc, **hyper)
    w = [x.clone() for x in w0]
    p = [x.to(torch.bfloat16) for x in w0]
    mu, nu = [torch.zeros(s) for s in shapes], [torch.zeros(s) for s in shapes]
    adam_update_master_reference(p, gr, w, mu, nu, sc, **hyper)
    for a, b, c in zip(w, p_c, p):
        assert torch.equal(a, b) and torch.equal(c, b.to(torch.bfloat16))
