"""Port SpecAugment (``data/augment.py``) against the JAX package's
``data/augment.py``.

The JAX masks come from ``jax.random`` keys, the port's from a torch
generator, so the bits cannot match. (i) The mask builder is held to JAX
bit for bit on JAX's own draws: the test splits the key and draws every
raw width and start exactly as JAX's ``spec_augment`` / ``_mask_axis`` do,
feeds them to ``spec_augment_masks`` and compares the augmented features
with JAX's, with the budgets and the adaptive count on and off. (ii) The
port's own draws pass the property tests of JAX's
``tests/test_data.py:165-240``. (iii) The augmentation stream leaves the
dropout bits of every (seed, step) as they were before SpecAugment was
ported, and the train step draws dropout from stream 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu.config import SpecAugmentConfig as JaxSpecCfg  # noqa: E402
from speech_tranformer_pytorch_tpu.data.augment import spec_augment as jax_spec_augment  # noqa: E402
from speech_tranformer_pytorch_tpu_torch import train as train_mod  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.config import SpecAugmentConfig, get_config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data.augment import (  # noqa: E402
    SpecAugmentDraws, apply_masks, draw_spec_augment, spec_augment, spec_augment_masks)
from speech_tranformer_pytorch_tpu_torch.data.pipeline import (  # noqa: E402
    make_audio_train_step, make_preprocess_fn)
from speech_tranformer_pytorch_tpu_torch.ops.dropout import (  # noqa: E402
    AUGMENT_STREAM, step_generator)
from speech_tranformer_pytorch_tpu_torch.profile_train import smoke_audio_batch  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.train import create_train_state  # noqa: E402

CASES = {
    "budgets_on": dict(max_total_frac=0.6),
    "budgets_off": dict(max_total_frac=0.0),
    "adaptive_count": dict(num_time_masks=10, time_mask_width=40,
                           time_masks_per_frame=0.02, max_total_frac=0.6),
    "large_preset": dict(num_time_masks=10, time_masks_per_frame=0.005),
}


def _jax_draws(key, b, t, f, cfg):
    """Every raw draw of JAX's ``spec_augment(key, ...)``: per utterance
    ``split(key, b)[i]`` -> (kf, kt); per axis ``split(k, 2·masks)``, the
    width from key 2m, the start from key 2m + 1."""
    def axis(k, n, length):
        ks = jax.random.split(k, n * 2)
        w = [jax.random.randint(ks[2 * m], (), 0, 10_000) for m in range(n)]
        s = [jax.random.randint(ks[2 * m + 1], (), 0, length) for m in range(n)]
        return jnp.stack(w), jnp.stack(s)

    def one(k):
        kf, kt = jax.random.split(k)
        return axis(kf, cfg.num_freq_masks, f) + axis(kt, cfg.num_time_masks, t)

    out = jax.jit(jax.vmap(one))(jax.random.split(key, b))
    return SpecAugmentDraws(*(torch.from_numpy(np.asarray(x).astype(np.int64)) for x in out))


@pytest.mark.parametrize("case", sorted(CASES))
def test_masks_equal_jax_on_jax_draws(case):
    over = dict(enabled=True, **CASES[case])
    jcfg, cfg = JaxSpecCfg(**over), SpecAugmentConfig(**over)
    b, t, f = 5, 300, 80
    feats = np.random.default_rng(3).standard_normal((b, t, f)).astype(np.float32)
    lens = np.array([300, 211, 120, 57, 4], np.int32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax_spec_augment(key, jnp.asarray(feats), jnp.asarray(lens), jcfg))
    draws = _jax_draws(key, b, t, f, cfg)
    fkeep, tkeep = spec_augment_masks(draws, torch.from_numpy(lens), t, f, cfg)
    got = apply_masks(torch.from_numpy(feats), fkeep, tkeep).numpy()
    assert (want == 0).any()
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(np.signbit(got), np.signbit(want))


def _augment(seed, feats, lens, cfg):
    return spec_augment(torch.Generator().manual_seed(seed), torch.as_tensor(feats),
                        torch.as_tensor(lens), cfg).numpy()


def test_masks_applied():
    cfg = SpecAugmentConfig(enabled=True, num_freq_masks=1, freq_mask_width=10,
                            num_time_masks=1, time_mask_width=20)
    out = _augment(0, np.ones((2, 100, 80), np.float32), np.array([100, 80]), cfg)
    assert out.shape == (2, 100, 80)
    assert 0.0 < float((out == 0).mean()) < 0.9


def test_disabled_identity():
    feats = torch.ones(1, 10, 8)
    out = spec_augment(torch.Generator().manual_seed(0), feats, torch.tensor([10]),
                       SpecAugmentConfig(enabled=False))
    assert out is feats


def test_different_seeds_different_masks():
    cfg = SpecAugmentConfig(enabled=True)
    feats, lens = np.ones((1, 200, 80), np.float32), np.array([200])
    assert not np.array_equal(_augment(1, feats, lens, cfg), _augment(2, feats, lens, cfg))


def test_budget_short_utterance_never_fully_masked():
    """max_total_frac holds on both axes even when the masks could cover
    the utterance many times over."""
    frac = 0.5
    cfg = SpecAugmentConfig(enabled=True, num_time_masks=8, time_mask_width=100,
                            time_mask_max_frac=1.0, max_total_frac=frac,
                            num_freq_masks=4, freq_mask_width=40)
    t, f, n_valid = 40, 80, 30
    for seed in range(50):
        out = _augment(seed, np.ones((1, t, f), np.float32), np.array([n_valid]), cfg)[0]
        alive_rows = (out[:n_valid] != 0).any(axis=1).sum()
        assert alive_rows >= int(n_valid * (1 - frac)), (seed, alive_rows)
        alive_cols = (out[:n_valid] != 0).any(axis=0).sum()
        assert alive_cols >= int(f * (1 - frac)), (seed, alive_cols)


def test_adaptive_time_mask_count():
    cfg = SpecAugmentConfig(enabled=True, num_freq_masks=0, num_time_masks=10,
                            time_mask_width=3, time_mask_max_frac=1.0,
                            time_masks_per_frame=0.01, max_total_frac=0.0)

    def count_spans(row_alive):
        a = np.concatenate([[True], row_alive, [True]])
        return int(((~a[1:]) & a[:-1]).sum())

    short_spans, long_spans = [], []
    for seed in range(30):
        out = _augment(seed, np.ones((2, 600, 8), np.float32), np.array([100, 600]), cfg)
        short_spans.append(count_spans((out[0] != 0).any(axis=1)))
        long_spans.append(count_spans((out[1] != 0).any(axis=1)))
    assert max(short_spans) <= 1, short_spans
    assert max(long_spans) > 1, long_spans


def test_draws_and_masks_stay_on_the_batch_shape():
    cfg = get_config("large").spec_augment
    g = torch.Generator().manual_seed(4)
    d = draw_spec_augment(g, 3, 500, 80, cfg)
    assert d.freq_width.shape == (3, cfg.num_freq_masks)
    assert d.time_start.shape == (3, cfg.num_time_masks)
    assert int(d.time_start.max()) < 500 and int(d.freq_start.max()) < 80
    fkeep, tkeep = spec_augment_masks(d, torch.tensor([500, 300, 20]), 500, 80, cfg)
    assert fkeep.shape == (3, 80) and tkeep.shape == (3, 500)


def test_dropout_bits_unchanged_by_the_augment_stream(monkeypatch):
    """Stream 0 keeps the dropout generator's seeding from before
    SpecAugment was ported (the same seed and bytes for a (seed, step));
    the augment stream is another generator; the train step with
    SpecAugment on still draws its dropout from stream 0 and its masks from
    the augment stream."""
    g = step_generator(1, 7, "cpu")
    assert g.initial_seed() == 4245214700
    assert torch.randint(0, 256, (12,), dtype=torch.uint8, generator=g).tolist() == [
        240, 177, 34, 91, 4, 253, 33, 229, 103, 56, 2, 64]
    assert step_generator(1, 7, "cpu", AUGMENT_STREAM).initial_seed() != 4245214700

    calls = []
    real = train_mod.step_generator
    monkeypatch.setattr(train_mod, "step_generator",
                        lambda *a, **k: calls.append((a, k)) or real(*a, **k))
    cfg = get_config("tiny", **{"model.num_encoder_layers": 1, "model.num_decoder_layers": 1,
                                "model.d_model": 32, "model.num_heads": 2, "model.d_ff": 64,
                                "model.subsample_channels": 4, "spec_augment.enabled": True})
    state = create_train_state(cfg, device="cpu", seed=0)
    batch = smoke_audio_batch(cfg, 2, device="cpu", seconds=(1.0, 1.5))
    make_audio_train_step(cfg)(state, batch, 5)
    assert [(a[0], a[1]) for a, k in calls] == [(5, 0)] and all(
        len(a) == 3 and not k for a, k in calls)

    pre = make_preprocess_fn(cfg.features, cfg.spec_augment)
    plain = pre(batch, "cpu")
    aug = pre(batch, "cpu", step_generator(5, 0, "cpu", AUGMENT_STREAM))
    want = spec_augment(step_generator(5, 0, "cpu", AUGMENT_STREAM), plain.feats,
                        plain.frame_lens, cfg.spec_augment)
    assert torch.equal(aug.feats, want) and not torch.equal(aug.feats, plain.feats)
    assert torch.equal(make_preprocess_fn(cfg.features, None)(batch, "cpu").feats,
                       plain.feats)
