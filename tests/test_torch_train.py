"""Port train step against the JAX package's ``make_audio_train_step``.

Both packages start from the same flax init of the tiny preset (dropout 0,
converted with ``convert.params_from_jax``) and the same zero optimizer
state (``convert.adam_state_from_jax``), and take one step on the same
``AudioBatch`` of seeded int16 utterances: fbank + CMVN, teacher-forced
forward, label-smoothed CE, backward, clip, Adam under Noam. The float32
step is held against both JAX optimizers (``train.fused_optimizer``
False, the optax chain, and True, ``FusedAdam``): the port has one. float32
compute with float32 moments agrees at 1e-5 on loss, tokens and accuracy,
1e-4 on the grad norm and on gradients and moments relative to each
leaf's largest value (summation order; see ``_leafwise`` for the key
biases), and params within 2·lr plus an f32 ulp (a first Adam step moves an element
by about ±lr, so an element whose gradient is rounding noise may flip).
A bfloat16-compute step (f32 masters, bf16 moments) is held at 2e-2 on
the loss and 5e-2 on the grad norm: both packages round activations and
weights to bf16, at different points. The port alone also shows its loss
falling over 30 steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu.config import get_config as jax_get_config  # noqa: E402
from speech_tranformer_pytorch_tpu.data.pipeline import (  # noqa: E402
    AudioBatch as JaxAudioBatch, make_audio_train_step as jax_audio_step,
    make_preprocess_fn as jax_preprocess)
from speech_tranformer_pytorch_tpu.train import create_train_state as jax_create  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.config import get_config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.convert import (  # noqa: E402
    _find_moments, adam_state_from_jax, params_from_jax, params_to_jax)
from speech_tranformer_pytorch_tpu_torch.data.pipeline import (  # noqa: E402
    AudioBatch, make_audio_train_step, make_preprocess_fn)
from speech_tranformer_pytorch_tpu_torch.data.synthetic import (  # noqa: E402
    make_utterances, pad_targets)
from speech_tranformer_pytorch_tpu_torch.train import (  # noqa: E402
    create_train_state, loss_and_grads, make_eval_step)

OVER = {"model.dropout_rate": 0.0, "model.num_encoder_layers": 2,
        "model.num_decoder_layers": 2}


def _audio_batch():
    audio, lens = make_utterances(3, min_seconds=0.7, max_seconds=1.3, seed=11)
    rng = np.random.default_rng(12)
    targets = [rng.integers(4, 64, size=n).tolist() for n in (6, 3, 9)]
    tin, tout, tlens = pad_targets(targets, 16)
    return dict(audio=audio, sample_lens=lens, targets_in=tin, targets_out=tout,
                target_lens=tlens, valid=np.ones(3, bool))


def _run(dtype, moment_dtype, fused_optimizer=False):
    over = dict(OVER, **{"model.dtype": dtype, "train.moment_dtype": moment_dtype,
                         "train.fused_optimizer": fused_optimizer})
    jcfg, cfg = jax_get_config("tiny", **over), get_config("tiny", **over)
    arrays = _audio_batch()
    jbatch = JaxAudioBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jstate = jax_create(jcfg, jax.random.PRNGKey(3), jax_preprocess(jcfg.features)(jbatch))
    params0 = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg.model)
    opt0 = adam_state_from_jax(jstate.opt_state, cfg.model)
    new_jstate, jm = jax_audio_step(jcfg, donate=False)(jstate, jbatch,
                                                        jax.random.PRNGKey(4))

    state = create_train_state(cfg, device="cpu", params=params0, opt=opt0)
    batch = AudioBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    grads, _ = loss_and_grads(cfg, state, make_preprocess_fn(cfg.features)(batch, "cpu"), 0)
    state, m = make_audio_train_step(cfg)(state, batch)
    return dict(cfg=cfg, jstate=new_jstate, jm={k: float(v) for k, v in jm.items()},
                state=state, m={k: float(v) for k, v in m.items()}, grads=grads,
                params0=params0, batch=batch)


@pytest.fixture(scope="module", params=[False, True], ids=["optax", "fused"])
def f32(request):
    """The JAX side with either of its optimizers (``train.fused_optimizer``:
    the optax chain, JAX's default, or ``FusedAdam``); the port runs its one
    fused Adam, the same function, against both (ROADMAP section C)."""
    return _run("float32", "float32", fused_optimizer=request.param)


def _leafwise(mine, theirs, cfg, rel, name):
    """Each leaf within ``rel`` of its largest value; the cross-attention
    key biases, whose exact gradient is zero (softmax ignores a shift shared
    by all keys) and whose computed one is rounding noise, within ``rel``
    of the largest value of all leaves."""
    want = {k: v.float().numpy() for k, v in params_from_jax(theirs, cfg.model).items()}
    top = max(np.abs(v).max() for v in want.values())
    for k, b in want.items():
        a = mine[k].detach().float().numpy()
        scale = top if k.endswith("cross_attn.k.bias") else max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() <= rel * scale, (name, k)


def test_f32_step_matches_jax(f32):
    m, jm, cfg = f32["m"], f32["jm"], f32["cfg"]
    for key in ("loss", "tokens", "accuracy", "lr", "audio_seconds"):
        assert m[key] == pytest.approx(jm[key], rel=1e-5), key
    assert m["grad_norm"] == pytest.approx(jm["grad_norm"], rel=1e-4)
    # The JAX step's first moments are 0.1·(clip scale)·g: its gradients.
    scale = min(1.0, cfg.train.grad_clip_norm / jm["grad_norm"])
    jmoments = _find_moments(f32["jstate"].opt_state)
    jmu = jmoments.mu
    _leafwise({k: g * (0.1 * scale) for k, g in f32["grads"].items()}, jmu, cfg, 1e-4, "grad")
    _leafwise(f32["state"].opt.mu, jmu, cfg, 1e-4, "mu")
    # Moments cross back to the JAX tree layout exactly.
    mu = f32["state"].opt.mu
    back = params_from_jax(params_to_jax(mu, cfg.model), cfg.model)
    assert all(torch.equal(back[k], mu[k]) for k in mu)
    _leafwise(f32["state"].opt.nu, jmoments.nu, cfg, 1e-4, "nu")
    assert int(f32["state"].opt.count) == 1 and f32["state"].step == 1
    want = params_from_jax(jax.tree.map(np.asarray, f32["jstate"].params), cfg.model)
    for k, p in f32["state"].params.items():
        tol = 2 * m["lr"] + np.finfo(np.float32).eps * want[k].abs()
        assert bool(((p.detach() - want[k]).abs() <= tol).all()), k
        assert not torch.equal(p.detach(), f32["params0"][k]), k


def test_eval_step_matches_train_loss(f32):
    cfg = f32["cfg"]
    state = create_train_state(cfg, device="cpu", params=f32["params0"])
    batch = make_preprocess_fn(cfg.features)(f32["batch"], "cpu")
    m = make_eval_step(cfg)(state, batch)
    assert float(m["loss"]) == pytest.approx(f32["m"]["loss"], rel=1e-6)


def test_bf16_step_matches_jax():
    r = _run("bfloat16", "bfloat16")
    assert r["m"]["loss"] == pytest.approx(r["jm"]["loss"], rel=2e-2)
    assert r["m"]["grad_norm"] == pytest.approx(r["jm"]["grad_norm"], rel=5e-2)
    mu = r["state"].opt.mu
    assert mu["decoder.embed.weight"].dtype == torch.bfloat16
    back = params_from_jax(params_to_jax(mu, r["cfg"].model), r["cfg"].model)
    assert all(torch.equal(back[k].to(torch.bfloat16), mu[k]) for k in mu)
    want = params_from_jax(jax.tree.map(np.asarray, r["jstate"].params), r["cfg"].model)
    for k, p in r["state"].params.items():
        assert p.dtype == torch.float32
        tol = 2 * r["m"]["lr"] + np.finfo(np.float32).eps * want[k].abs()
        assert bool(((p.detach() - want[k]).abs() <= tol).all()), k


def test_loss_falls_over_30_steps():
    cfg = get_config("tiny", **OVER)
    state = create_train_state(cfg, device="cpu", seed=0)
    batch = AudioBatch(**{k: torch.from_numpy(v) for k, v in _audio_batch().items()})
    step = make_audio_train_step(cfg)
    losses = []
    threads = torch.get_num_threads()
    torch.set_num_threads(2)   # the suite's workers share the machine's cores
    try:
        for _ in range(30):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
    finally:
        torch.set_num_threads(threads)
    assert all(np.isfinite(losses)) and losses[-1] < 0.6 * losses[0], losses


@pytest.mark.parametrize("kernel,group", [
    ("void (anonymous namespace)::flash_fwd_bf16_kernel<64>(Params)", "flash_fwd"),
    ("void (anonymous namespace)::flash_fwd_kernel<32, 32>(Params)", "flash_fwd"),
    ("void (anonymous namespace)::flash_bwd_dq_bf16_kernel<64>(Params)", "flash_bwd_dq"),
    ("void (anonymous namespace)::adam_kernel<__nv_bfloat16>(...)", "fused_adam"),
    ("nvjet_tst_128x64_64x8_2x1_v_bz_TNT", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise/other"),
])
def test_profile_groups_name_each_kernel(kernel, group):
    """profile_train's device-time groups find the port's kernels by name,
    the bf16 and f32 flash forward alike."""
    from speech_tranformer_pytorch_tpu_torch.profile_train import _group

    assert _group(kernel) == group
