"""The Conformer encoder of the port (``model.encoder='conformer'``,
``models/conformer.py``, ``kernels/relpos_attention.py``) on the CPU at a
tiny size: d 32, 4 heads, 2 blocks, kernel 7, T' up to 48, seeded weights
with BatchNorm statistics far from the identity.

The encoder is held to the benchmark's reference (``portbench/reference/
conformer.py``, written from the equations: the position term materialised
and shifted by ESPnet's pad-and-view ``rel_shift``) in float32 within 1e-5
(float32 sums of the same products in another order); the kernel's plain
version (a gather of the shifted diagonal) to the reference's ``rel_shift``
at the first row, the last row and the keys at the length edge; an
utterance's memory to itself padded into a longer batch; the served hybrid
search's scores to the reference's judge; one training step's loss and
per-leaf gradient norms to the reference's autograd (its CTC term through
``F.ctc_loss``: the reference's float64 forward algorithm is not built for
gradients). The configuration
fields are port-only (every existing preset's dictionary and hashes stay
the JAX package's) and every path the Conformer lacks refuses."""

import math
import types

import pytest

torch = pytest.importorskip("torch")

from torch.nn import functional as F  # noqa: E402

from portbench.reference import conformer as ref  # noqa: E402
from portbench.reference import ctc as ref_ctc  # noqa: E402
from portbench.reference.model import decode as ref_decode  # noqa: E402
from speech_tranformer_pytorch_tpu import config as jcfg  # noqa: E402
from speech_tranformer_pytorch_tpu_torch import config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data.synthetic import make_utterances  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.kernels import relpos_attention as rp  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.models import SpeechTransformer  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.recognize import Recognizer  # noqa: E402

WEIGHT, BEAM = 0.3, 4
SMALL = {"model.d_model": 32, "model.num_heads": 4, "model.d_ff": 64,
         "model.num_encoder_layers": 2, "model.num_decoder_layers": 2,
         "model.conv_kernel": 7, "model.subsample_channels": 8, "model.vocab_size": 40,
         "data.bpe_vocab_size": 40, "model.dropout_rate": 0.0,
         "model.attention_dropout_rate": 0.0, "model.dtype": "float32",
         "features.output_dtype": "float32", "model.max_source_positions": 64,
         "spec_augment.enabled": False}


def _config(**over):
    return config.get_config("librispeech_conformer", **{**SMALL, **over}).validate()


def _params(cfg, seed: int = 0):
    """Seeded weights: <eos>'s tied row zero (it never wins a search), the
    BatchNorm statistics drawn far from the identity."""
    g = torch.Generator().manual_seed(seed)
    model = SpeechTransformer(cfg.model).init_weights(g)
    with torch.no_grad():
        model.decoder.embed.weight[2].zero_()
        for layer in model.encoder.layers:
            layer.conv.norm.running_mean.normal_(0.0, 0.3, generator=g)
            layer.conv.norm.running_var.uniform_(0.5, 2.0, generator=g)
    return model.state_dict()


def _model(cfg, params):
    model = SpeechTransformer(cfg.model)
    model.load_state_dict(params)
    return model.eval()


def _feats(frames=(195, 150, 61), seed: int = 1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(len(frames), max(frames), 80, generator=g), torch.tensor(frames)


def test_encoder_matches_the_reference():
    cfg = _config()
    params = _params(cfg)
    feats, lens = _feats()
    with torch.no_grad():
        memory, mem_lens = _model(cfg, params).encode(feats, lens)
        want, want_lens = ref.encode(params, cfg.to_dict()["model"], feats, lens)
    assert memory.shape[1] == 48 and torch.equal(mem_lens, want_lens)
    assert torch.allclose(memory, want, atol=1e-5, rtol=0)
    # The BatchNorm statistics take part: the identity gives another memory.
    plain = dict(params)
    for name in plain:
        if name.endswith("running_mean"):
            plain[name] = torch.zeros_like(plain[name])
    with torch.no_grad():
        other, _ = _model(cfg, plain).encode(feats, lens)
    assert (other - memory).abs().max() > 1e-2


@pytest.mark.parametrize("lengths", [(9, 9), (9, 5), (9, 1)])
def test_plain_version_matches_rel_shift_at_the_edges(lengths):
    """The first and the last query row and the keys at the length edge
    read the positions ``rel_shift`` gives them; rows past a length are
    zero."""
    b, t, h, d = len(lengths), 9, 2, 8
    g = torch.Generator().manual_seed(sum(lengths))
    q, k, v = torch.randn(3, b, t, h, d, generator=g).unbind(0)
    p = torch.randn(2 * t - 1, h, d, generator=g)
    u, vb = torch.randn(2, h, d, generator=g).unbind(0)
    lens = torch.tensor(lengths)
    got = rp.relpos_attention_reference(q, k, v, p, u, vb, lens)
    ac = torch.einsum("bihd,bjhd->bhij", q + u, k)
    bd = ref.rel_shift(torch.einsum("bihd,rhd->bhir", q + vb, p))
    for i, j in ((0, 0), (0, t - 1), (t - 1, 0), (t - 1, t - 1)):   # rel_shift's corners
        assert torch.allclose(bd[..., i, j], torch.einsum("bhd,hd->bh", q[:, i] + vb,
                                                          p[t - 1 - i + j]), atol=1e-6)
    s = (ac + bd) / math.sqrt(d)
    keep = torch.arange(t)[None, :] < lens[:, None]
    w = torch.softmax(s.masked_fill(~keep[:, None, None, :], float("-inf")), -1)
    want = torch.einsum("bhij,bjhd->bihd", w, v) * keep[..., None, None]
    assert torch.allclose(got, want, atol=1e-6)
    for r, n in enumerate(lengths):    # the key at the edge weighs in, the one past it not
        assert float(w[r, :, 0, n - 1].min()) > 0.0
        if n < t:
            assert float(w[r, :, 0, n].max()) == 0.0 and float(got[r, n:].abs().max()) == 0.0


def test_padding_to_a_longer_bucket_leaves_an_utterance_alone():
    cfg = _config()
    model = _model(cfg, _params(cfg))
    feats, lens = _feats((195, 90))
    with torch.no_grad():
        padded, mem_lens = model.encode(feats, lens)
        alone, _ = model.encode(feats[1:, :90], lens[1:])
    n = int(mem_lens[1])
    assert alone.shape[1] == n
    assert torch.allclose(padded[1, :n], alone[0], atol=1e-5, rtol=0)
    assert float(padded[1, n:].abs().max()) == 0.0


def test_served_hybrid_scores_match_the_reference_judge():
    cfg = _config()
    params = _params(cfg)
    audio, lens = make_utterances(3, min_seconds=0.8, max_seconds=1.4, seed=4)
    audio, lens = torch.from_numpy(audio), torch.from_numpy(lens)
    rec = Recognizer(cfg, params, device="cpu")
    got = rec.decode_result(audio, lens, beam_size=BEAM, max_len=6, alpha=1.0)
    assert got.steps == 6 and bool((got.lengths == 6).all())
    judged, gaps = ref.judge(params, cfg.to_dict(), audio, lens, got.tokens, got.lengths, 1.0,
                             WEIGHT)
    assert torch.allclose(got.scores.double(), judged, atol=2e-4)
    assert max(gaps) < 1e-3 and max(gaps) > -math.inf
    scores, tokens = ref.beam_search(params, cfg.to_dict(), audio, lens, BEAM, 6, 1.0, WEIGHT)
    assert torch.equal(got.tokens.long(), tokens)


def test_one_training_step_matches_the_reference_autograd():
    from portbench.reference.train import smoothed_ce_sum
    from speech_tranformer_pytorch_tpu_torch.train import (Batch, create_train_state,
                                                           loss_and_grads)

    cfg = _config()
    params = _params(cfg, seed=5)
    state = create_train_state(cfg, device="cpu", params=params)
    g = torch.Generator().manual_seed(7)
    b, u = 3, 6
    feats, frame_lens = _feats((150, 131, 99), seed=2)
    target_lens = torch.tensor([6, 4, 3])                              # with the <eos>
    labels = torch.randint(4, cfg.model.vocab_size, (b, u), generator=g)
    pos = torch.arange(u)[None]
    tout = torch.where(pos < target_lens[:, None] - 1, labels, 0)
    tout = torch.where(pos == target_lens[:, None] - 1, 2, tout)
    tin = torch.cat([torch.ones(b, 1, dtype=torch.long), tout[:, :-1]], 1)
    tin = torch.where(tin == 2, 0, tin)
    grads, metrics = loss_and_grads(cfg, state, Batch(feats, frame_lens, tin, tout, target_lens),
                                    seed=0)
    m = cfg.to_dict()["model"]
    leaves = {k: v.detach().clone().requires_grad_(k in grads) for k, v in params.items()}
    memory, mem_lens = ref.encode(leaves, m, feats, frame_lens, bn_train=True)
    logits = ref_decode(leaves, m, tin, target_lens, memory, mem_lens)
    tokens = float((tout != 0).sum())
    ce = smoothed_ce_sum(logits, tout, cfg.train.label_smoothing) / tokens
    lp = ref_ctc.log_probs(leaves, memory)
    ctc = F.ctc_loss(lp.transpose(0, 1), tout, mem_lens, target_lens - 1, reduction="sum",
                     zero_infinity=True) / tokens
    loss = (1 - WEIGHT) * ce + WEIGHT * ctc
    want = dict(zip([k for k in grads], torch.autograd.grad(loss, [leaves[k] for k in grads])))
    assert float(metrics["loss"]) == pytest.approx(float(loss.detach()), rel=1e-5)
    for name, grad in grads.items():
        gn, wn = float(grad.norm()), float(want[name].norm())
        assert gn == pytest.approx(wn, rel=1e-3, abs=1e-6), name


@pytest.mark.parametrize("preset", sorted(jcfg.PRESETS))
def test_existing_presets_keep_their_jax_dictionary_and_hashes(preset):
    cfg, jax = config.get_config(preset), jcfg.get_config(preset)
    assert cfg.model.encoder == "transformer" and cfg.model.conv_kernel == 31
    assert cfg.jax_dict() == jax.to_dict()
    assert (cfg.config_hash(), cfg.model_hash()) == (jax.config_hash(), jax.model_hash())
    conformer = config.get_config("librispeech_conformer")
    assert conformer.jax_dict()["model"]["encoder"] == "conformer"
    assert conformer.model_hash() != config.get_config("librispeech").model_hash()


def test_paths_the_conformer_lacks_refuse():
    from speech_tranformer_pytorch_tpu_torch.serving import export_recognizer

    cfg = _config()
    params = _params(cfg)
    with pytest.raises(ValueError, match="single-device"):
        SpeechTransformer(cfg.model, mesh=types.SimpleNamespace(tp=1))
    with pytest.raises(ValueError, match="no ring attention"):
        _config(**{"model.attention_impl": "ring"})
    with pytest.raises(ValueError, match="no ring attention"):
        SpeechTransformer(cfg.model.replace(attention_impl="ring"))
    with pytest.raises(ValueError, match="no int8 serving path"):
        Recognizer(cfg.replace(decode=cfg.decode.replace(int8_weights=True, ctc_weight=0.0)),
                   params, device="cpu")
    with pytest.raises(ValueError, match="cannot be exported"):
        export_recognizer(cfg, params, batch_size=1, frames=60, beam_size=BEAM, max_len=4,
                          device="cpu")
    with pytest.raises(ValueError, match="without remat"):
        _config(**{"model.remat": True})
