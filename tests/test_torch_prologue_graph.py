"""A served call's prologue on the graph arena (port
``decoding/beam_graph.graph_beam_decode``: the features, encoder, caches
and initial state written from the PCM into the arena, then the arena's
step), run eagerly on the CPU as a card runs a call shape's first call:
bit-equal to ``Recognizer.decode_result``'s eager route
(``extract_features`` then ``beam_decode``) in tokens, lengths, scores
and steps, for an attention-only model (with random weights, and with
<eos> raised so that the early stop ends the search), a hybrid CTC/attention
model and int8 serving, over two PCM shapes, a larger one that grows the
arena and the first again, with every buffer of the arena poisoned between
calls; each such call counts one eager prologue. The two routes compute
the features and encoder each on their own, so the comparison runs on one
CPU thread: a multi-threaded CPU product may split its sums by the threads
it is given, which can vary with the machine's load. And the routing: only a
beam search on a card without a mesh, outside ``torch.export``, starts from
the PCM on the arena; greedy decoding, a mesh, export and the CPU keep the
route through ``extract_features``."""

import types

import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu_torch import recognize  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.config import get_config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data.synthetic import make_utterances  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data.tokenizer import EOS  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.decoding import beam_graph  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.kernels import interface  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.models import SpeechTransformer  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.recognize import Recognizer  # noqa: E402

BEAM, MAX_LEN = 4, 8
SMALL = {"model.d_model": 64, "model.num_heads": 4, "model.d_ff": 128,
         "model.num_encoder_layers": 2, "model.num_decoder_layers": 2,
         "model.subsample_channels": 8, "model.vocab_size": 40, "model.dropout_rate": 0.0}
MODELS = {   # name -> (config overrides, <eos> logit shift, alpha)
    "attention": ({}, 0.0, 1.0),
    "attention_finishing": ({}, 7.0, 0.0),
    "hybrid": ({"model.ctc_head": True, "decode.ctc_weight": 0.4}, 0.0, 1.0),
    "int8": ({"decode.int8_weights": True, "decode.int8_kv_cache": True}, 0.0, 1.0),
}
# (batch, shortest s, longest s, seed): two shapes, a larger one, the first again
CALLS = [(2, 0.8, 1.0, 1), (3, 0.6, 0.8, 2), (3, 1.3, 1.6, 3), (2, 0.8, 1.0, 1)]


def _recognizer(name: str) -> Recognizer:
    over, eos_shift, _ = MODELS[name]
    cfg = get_config("tiny", **{**SMALL, **over})
    model = SpeechTransformer(cfg.model).init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        row = model.decoder.embed.weight[EOS]
        model.decoder.final_norm.bias += eos_shift * row / row.dot(row)
    return Recognizer(cfg, model.state_dict(), device="cpu")


def _poison(graphs) -> None:
    """What an earlier call could leave: non-finite floats, stray ids, a
    set flag, in every buffer of the arena, the PCM's included."""
    for buf in graphs._buffers.values():
        if buf.is_floating_point():
            buf.fill_(float("nan"))
        elif buf.dtype == torch.bool:
            buf.fill_(True)
        else:
            buf.fill_(3)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", list(MODELS))
def test_prologue_on_the_arena_equals_the_eager_route(name, one_thread):
    rec = _recognizer(name)
    alpha = MODELS[name][2]
    kw = dict(beam_size=BEAM, max_len=MAX_LEN, alpha=alpha)
    pcm_ptrs, steps = [], []
    for batch, low, high, seed in CALLS:
        audio, lens = make_utterances(batch, min_seconds=low, max_seconds=high, seed=seed)
        want = rec.decode_result(audio, lens, **kw)
        interface.reset_decode_step_counts()
        got = beam_graph.graph_beam_decode(rec.model, audio, lens, rec.cfg.features,
                                           int8_kv=rec.int8_kv, ctc_weight=rec.ctc_weight,
                                           **kw)
        assert interface.decode_step_counts() == {
            "captures": 0, "replays": 0, "eager_steps": got.steps, "prologue_captures": 0,
            "prologue_replays": 0, "prologue_eager": 1}
        assert got.steps == want.steps
        assert torch.equal(got.tokens, want.tokens)
        assert torch.equal(got.lengths, want.lengths)
        assert torch.equal(got.scores, want.scores)
        graphs = beam_graph._GRAPHS[rec.model]
        pcm_ptrs.append(graphs._buffers[("pcm", torch.int16)].data_ptr())
        steps.append(got.steps)
        _poison(graphs)
    assert pcm_ptrs[2] != pcm_ptrs[1] and pcm_ptrs[3] == pcm_ptrs[2]   # grown once, kept
    if MODELS[name][1] > 0.0:   # the flag the prologue computes, then the steps', stopped it
        assert min(steps) < MAX_LEN
    else:
        assert steps == [MAX_LEN] * len(CALLS)


def test_only_a_card_beam_search_without_mesh_or_export_starts_from_the_pcm(monkeypatch):
    rec = _recognizer("attention")
    audio, lens = make_utterances(2, min_seconds=0.8, max_seconds=1.0, seed=1)
    seen = []

    def fake(name, result=None):
        def call(*args, **kwargs):
            seen.append(name)
            return result if result is not None else types.SimpleNamespace(steps=3)
        return call

    monkeypatch.setattr(recognize, "graph_beam_decode", fake("graph"))
    monkeypatch.setattr(recognize, "extract_features", fake("features", (None, None)))
    monkeypatch.setattr(recognize, "beam_decode", fake("beam"))
    monkeypatch.setattr(recognize, "greedy_decode", fake("greedy"))
    monkeypatch.setattr(recognize, "make_sharded_beam_decode", fake("sharded", fake("mesh")))

    def route(beam_size: int):
        seen.clear()
        rec.decode_result(audio, lens, beam_size=beam_size, max_len=MAX_LEN, alpha=1.0)
        return list(seen)

    assert route(BEAM) == ["features", "beam"]                  # the CPU
    monkeypatch.setattr(rec, "device", torch.device("cuda"))
    assert route(BEAM) == ["graph"]                             # a card
    assert route(1) == ["features", "greedy"]                   # greedy
    monkeypatch.setattr(recognize, "data_rows", lambda x, mesh: x)
    monkeypatch.setattr(rec, "mesh", object())
    monkeypatch.setattr(rec.model.decoder, "mesh", rec.mesh)
    assert route(BEAM) == ["features", "sharded", "mesh"]       # a mesh
    monkeypatch.setattr(rec, "mesh", None)
    monkeypatch.setattr(rec.model.decoder, "mesh", None)
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    assert route(BEAM) == ["features", "beam"]                  # export
    assert rec.last_steps == 3

