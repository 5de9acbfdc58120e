"""The hybrid CTC/attention model of the port (``model.ctc_head``,
``train.ctc_weight``, ``decode.ctc_weight``) on the CPU at tiny sizes.

The prefix scorer's plain version (``kernels/ctc_prefix.py``, ESPnet's
recursion) and the benchmark's reference (``portbench/reference/ctc.py``,
the forward algorithm over the blank-extended labels) are both held to
brute-force enumeration of alignments and to ``F.ctc_loss``; the port's
hybrid beam search (eager, and the arena form of the graph path) to the
reference's own hybrid search; weight 0 to the attention-only search;
the early stop to the search without it; and every path with no CTC
scorer must refuse a nonzero weight."""

import itertools
import math

import pytest

torch = pytest.importorskip("torch")

from torch.nn import functional as F  # noqa: E402

from portbench.reference import ctc as ref  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.config import get_config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data.synthetic import make_utterances  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.decoding import beam, beam_graph  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.kernels import ctc_prefix, interface  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.models import SpeechTransformer  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.recognize import Recognizer  # noqa: E402

LOGZERO = ctc_prefix.LOGZERO
BEAM, WEIGHT = 4, 0.4
SMALL = {"model.d_model": 64, "model.num_heads": 4, "model.d_ff": 128,
         "model.num_encoder_layers": 2, "model.num_decoder_layers": 2,
         "model.subsample_channels": 8, "model.vocab_size": 40, "model.dropout_rate": 0.0,
         "model.ctc_head": True, "decode.ctc_weight": WEIGHT}


def _log_probs(t: int, v: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.log_softmax(2.0 * torch.randn(t, v, generator=g, dtype=torch.float64), -1)


def _enumerate(lp: torch.Tensor, y):
    """(log P(labels begin with y), log P(labels are y)) over every
    alignment of the frames of ``lp`` [T, V] (blank 0)."""
    t, v = lp.shape
    prefix, whole = [], []
    for a in itertools.product(range(v), repeat=t):
        labels = [c for i, c in enumerate(a) if c != 0 and (i == 0 or a[i - 1] != c)]
        p = float(sum(lp[i, c] for i, c in enumerate(a)))
        if tuple(labels[:len(y)]) == y:
            prefix.append(p)
            if len(labels) == len(y):
                whole.append(p)
    def lse(xs):
        return float(torch.logsumexp(torch.tensor(xs, dtype=torch.float64), 0)) if xs else -math.inf

    return lse(prefix), lse(whole)


def _recursion(lp: torch.Tensor, y, frames: int, eos: int):
    """ψ(y) and the probability of y as the whole transcript, step by step
    through the plain scorer from the <sos> state, over the first
    ``frames`` frames of ``lp`` [T, V] (the rest padded as ESPnet pads)."""
    logp = lp.float().clone()
    logp[frames:] = LOGZERO
    logp[frames:, 0] = 0.0
    logp = logp.t()[None].contiguous()                                # [1, V, T]
    state = torch.stack([torch.full_like(logp[0, 0], LOGZERO), torch.cumsum(logp[0, 0], 0)])[None]
    lens = torch.tensor([frames], dtype=torch.int32)
    last, psi = torch.tensor([1], dtype=torch.int32), None
    for n, c in enumerate(y):
        psi, states = ctc_prefix.ctc_prefix_reference(
            logp, state, last, torch.tensor([[c]], dtype=torch.int32),
            torch.tensor(n, dtype=torch.int32), lens, beams=1, eos=eos)
        state, last = states[:, 0], torch.tensor([c], dtype=torch.int32)
    whole, _ = ctc_prefix.ctc_prefix_reference(
        logp, state, last, torch.tensor([[eos]], dtype=torch.int32),
        torch.tensor(len(y), dtype=torch.int32), lens, beams=1, eos=eos)
    return float(psi[0, 0]), float(whole[0, 0])


CASES = [((3,), 6, 6), ((3, 4), 6, 5), ((3, 3), 6, 6), ((4, 3, 4), 6, 6), ((3, 3, 4), 5, 5),
         ((4,), 4, 3)]


@pytest.mark.parametrize("y,t,frames", CASES)
def test_prefix_scores_equal_enumeration(y, t, frames):
    lp = _log_probs(t, 5, seed=len(y) * 10 + t)
    want_prefix, want_whole = _enumerate(lp[:frames], y)
    psi, whole = _recursion(lp, y, frames, eos=2)
    assert psi == pytest.approx(want_prefix, abs=2e-5)
    assert whole == pytest.approx(want_whole, abs=2e-5)
    # The reference's forward algorithm, a derivation of its own.
    labels = torch.tensor([y])
    utt, lens = torch.zeros(1, dtype=torch.long), torch.tensor([frames])
    got = ref.prefix_log_probs(lp[None], labels, utt, lens)[0, -1]
    assert float(got) == pytest.approx(want_prefix, abs=1e-9)
    seq = ref.sequence_log_prob(lp[None], labels, torch.tensor([len(y)]), lens)
    assert float(seq[0]) == pytest.approx(want_whole, abs=1e-9)


def test_whole_sequence_probability_equals_ctc_loss():
    t, v = 30, 9
    lp = torch.stack([_log_probs(t, v, seed=s) for s in range(4)])     # [B, T, V]
    g = torch.Generator().manual_seed(5)
    labels = torch.randint(3, v, (4, 7), generator=g)
    labels[1, 2] = labels[1, 1]                                        # a repeat
    n = torch.tensor([7, 5, 1, 3])
    lens = torch.tensor([30, 24, 9, 17])
    want = -F.ctc_loss(lp.transpose(0, 1), labels, lens, n, blank=0, reduction="none")
    assert torch.allclose(ref.sequence_log_prob(lp, labels, n, lens), want, atol=1e-8)
    for b in range(4):
        _, whole = _recursion(lp[b], tuple(labels[b, :n[b]].tolist()), int(lens[b]), eos=2)
        assert whole == pytest.approx(float(want[b]), abs=1e-3)


def _config(**over):
    return get_config("tiny", **{**SMALL, **over})


def _params(cfg, seed: int = 0):
    model = SpeechTransformer(cfg.model).init_weights(torch.Generator().manual_seed(seed))
    with torch.no_grad():   # <eos> never wins: its tied row gives logit 0
        model.decoder.embed.weight[2].zero_()
    return model.state_dict()


def _audio(batch: int = 3):
    audio, lens = make_utterances(batch, min_seconds=0.8, max_seconds=1.4, seed=4)
    return torch.from_numpy(audio), torch.from_numpy(lens)


def test_hybrid_beam_search_matches_the_reference():
    cfg = _config()
    params = _params(cfg)
    audio, lens = _audio()
    rec = Recognizer(cfg, params, device="cpu")
    max_len = 6
    got = rec.decode_result(audio, lens, beam_size=BEAM, max_len=max_len, alpha=1.0)
    scores, tokens = ref.beam_search(params, cfg.to_dict(), audio, lens, BEAM, max_len, 1.0,
                                     WEIGHT)
    assert got.steps == max_len and bool((got.lengths == max_len).all())
    assert torch.equal(got.tokens.long(), tokens)
    assert torch.allclose(got.scores.double(), scores, atol=2e-4)
    # The reference's judge reads rounding on the port's own output.
    judged, gaps = ref.judge(params, cfg.to_dict(), audio, lens, got.tokens, got.lengths, 1.0,
                             WEIGHT)
    assert torch.allclose(got.scores.double(), judged, atol=2e-4)
    assert max(gaps) < 1e-3 and max(gaps) > -math.inf


def _memory(cfg, params, frames=(90, 83, 76), seed: int = 1):
    model = SpeechTransformer(cfg.model)
    model.load_state_dict(params)
    model.eval()
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(len(frames), max(frames), cfg.model.input_dim, generator=g)
    with torch.no_grad():
        memory, mem_lens = model.encode(feats, torch.tensor(frames))
    return model, memory, mem_lens


def _same(a, b):
    assert a.steps == b.steps
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.lengths, b.lengths)
    assert torch.equal(a.scores, b.scores)


def _finishing(model):
    """<eos> given a row and raised, and the CTC head made to favour
    blank, so that hypotheses end under the combined score and the early
    stop fires."""
    with torch.no_grad():
        row = model.decoder.embed.weight[2]
        row.copy_(torch.randn(row.shape, generator=torch.Generator().manual_seed(9)))
        model.decoder.final_norm.bias += 7.0 * row / row.dot(row)
        model.ctc.bias[0] += 12.0
    return model


@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("finish", [False, True])
def test_graph_path_equals_eager_search(early_stop, finish):
    cfg = _config()
    model, memory, mem_lens = _memory(cfg, _params(cfg))
    if finish:
        _finishing(model)
    kw = dict(beam_size=BEAM, max_len=8, alpha=0.0 if finish else 1.0, early_stop=early_stop,
              ctc_weight=WEIGHT)
    want = beam.eager_beam_search(model, memory, mem_lens, **kw)
    _same(beam_graph.graph_beam_search(model, memory, mem_lens, **kw), want)
    # A second call, a smaller shape, then the first again on one arena.
    small = memory[:2, :15], mem_lens[:2].clamp(max=15)
    _same(beam_graph.graph_beam_search(model, *small, **kw),
          beam.eager_beam_search(model, *small, **kw))
    _same(beam_graph.graph_beam_search(model, memory, mem_lens, **kw), want)


def test_early_stop_stays_exact():
    cfg = _config()
    model, memory, mem_lens = _memory(cfg, _params(cfg))
    _finishing(model)
    kw = dict(beam_size=BEAM, max_len=10, alpha=0.0, ctc_weight=WEIGHT)
    stopped = beam.eager_beam_search(model, memory, mem_lens, early_stop=True, **kw)
    full = beam.eager_beam_search(model, memory, mem_lens, early_stop=False, **kw)
    assert stopped.steps < 10 and full.steps == 10
    assert torch.equal(stopped.tokens, full.tokens) and torch.equal(stopped.scores, full.scores)


def test_prefix_scores_only_fall():
    """ψ(g·c) <= ψ(g) and the whole-transcript probability <= ψ(g): both
    parts of a combined score only fall, which the early stop's bound
    needs."""
    t, v, k = 40, 12, 3
    lp = torch.stack([_log_probs(t, v, seed=s) for s in range(2)]).float()
    logp = lp.transpose(1, 2).contiguous()
    lens = torch.tensor([40, 31], dtype=torch.int32)
    blank = logp[:, 0]
    state = torch.stack([torch.full_like(blank, LOGZERO), torch.cumsum(blank, 1)], 1)
    state = state.repeat_interleave(k, 0)
    psi_g = torch.zeros(2 * k)
    last = torch.ones(2 * k, dtype=torch.int32)
    g = torch.Generator().manual_seed(0)
    for n in range(6):
        cand = torch.randint(3, v, (2 * k, 5), generator=g, dtype=torch.int32)
        cand[:, -1] = 2                                                # <eos>
        psi, states = ctc_prefix.ctc_prefix_reference(
            logp, state, last, cand, torch.tensor(n, dtype=torch.int32), lens, beams=k, eos=2)
        assert bool((psi <= psi_g[:, None] + 1e-4).all())
        pick = torch.tensor([1, 3, 0, 0, 2, 3])
        psi_g = psi[torch.arange(2 * k), pick]
        state = states[torch.arange(2 * k), pick]
        last = cand[torch.arange(2 * k), pick]


def test_zero_weight_is_the_attention_search(monkeypatch):
    cfg = _config(**{"decode.ctc_weight": 0.0})
    params = _params(cfg)
    plain_cfg = _config(**{"decode.ctc_weight": 0.0, "model.ctc_head": False})
    plain = {k: v for k, v in params.items() if not k.startswith("ctc.")}
    audio, lens = _audio()

    def no_scorer(*a, **kw):
        raise AssertionError("the CTC scorer ran at weight 0")

    monkeypatch.setattr(interface, "ctc_prefix_scores", no_scorer)
    kw = dict(beam_size=BEAM, max_len=6, alpha=1.0)
    got = Recognizer(cfg, params, device="cpu").decode_result(audio, lens, **kw)
    want = Recognizer(plain_cfg, plain, device="cpu").decode_result(audio, lens, **kw)
    _same(got, want)
    model, memory, mem_lens = _memory(cfg, params)
    carry = beam.initial_carry(3, BEAM, 6, memory.device, {}, True)
    assert "ctc_state" not in carry and "ctc_psi" not in carry


def test_paths_without_a_ctc_scorer_refuse_a_weight():
    from speech_tranformer_pytorch_tpu_torch.serving import export_recognizer

    cfg = _config()
    params = _params(cfg)
    audio, lens = _audio()
    rec = Recognizer(cfg, params, device="cpu")
    with pytest.raises(ValueError, match="greedy search"):
        rec.decode_result(audio, lens, beam_size=1, max_len=4, alpha=1.0)
    with pytest.raises(ValueError, match="cannot be exported"):
        export_recognizer(cfg, params, batch_size=1, frames=60, beam_size=BEAM, max_len=4,
                          device="cpu")
    for over in ({"decode.int8_weights": True}, {"decode.int8_kv_cache": True}):
        with pytest.raises(ValueError, match="no int8 serving path"):
            Recognizer(_config(**over), params, device="cpu")
    with pytest.raises(ValueError, match="single-device"):
        SpeechTransformer(cfg.model, mesh=type("M", (), {"tp": 1})())
    with pytest.raises(ValueError, match="needs model.ctc_head"):
        _config(**{"model.ctc_head": False}).validate()
    with pytest.raises(ValueError, match="needs model.ctc_head"):
        _config(**{"model.ctc_head": False, "decode.ctc_weight": 0.0,
                   "train.ctc_weight": 0.3}).validate()
    plain = SpeechTransformer(_config(**{"model.ctc_head": False}).model)
    with pytest.raises(ValueError, match="CTC head"):
        beam.beam_search(plain, torch.zeros(1, 5, 64), torch.tensor([5]), beam_size=BEAM,
                         max_len=3, ctc_weight=WEIGHT)


def test_joint_loss_is_the_weighted_ctc_and_attention_losses():
    from speech_tranformer_pytorch_tpu_torch.train import (Batch, create_train_state,
                                                           loss_and_grads)

    w = 0.3
    cfg = _config(**{"train.ctc_weight": w})
    state = create_train_state(cfg, device="cpu", seed=3)
    g = torch.Generator().manual_seed(7)
    b, t, u = 3, 60, 6
    feats = torch.randn(b, t, cfg.model.input_dim, generator=g)
    frame_lens = torch.tensor([60, 52, 41])
    target_lens = torch.tensor([6, 4, 3])                              # with the <eos>
    labels = torch.randint(4, cfg.model.vocab_size, (b, u), generator=g)
    pos = torch.arange(u)[None]
    tout = torch.where(pos < target_lens[:, None] - 1, labels, 0)
    tout = torch.where(pos == target_lens[:, None] - 1, 2, tout)
    tin = torch.cat([torch.ones(b, 1, dtype=torch.long), tout[:, :-1]], 1)
    tin = torch.where(tin == 2, 0, tin)
    batch = Batch(feats, frame_lens, tin, tout, target_lens)
    _, metrics = loss_and_grads(cfg, state, batch, seed=0)
    # The reference's forward algorithm on the reference's own encoder.
    params = {k: v.detach() for k, v in state.model.state_dict().items()}
    memory, mem_lens = ref.encode(params, cfg.to_dict()["model"], feats, frame_lens)
    lp = ref.log_probs(params, memory).double()
    nll = -ref.sequence_log_prob(lp, tout, target_lens - 1, mem_lens).sum()
    want_ctc = float(nll) / float(metrics["tokens"])
    assert float(metrics["ctc_loss"]) == pytest.approx(want_ctc, rel=1e-4)
    assert float(metrics["loss"]) == pytest.approx(
        (1 - w) * float(metrics["att_loss"]) + w * float(metrics["ctc_loss"]), rel=1e-6)
