"""The beam step a CUDA graph captures (port ``decoding/beam_graph.py``),
run eagerly on the CPU over its static arena with a device-style 0-d step
index (tiny preset, float32): bit-equal to ``eager_beam_search`` (tokens,
lengths, scores and steps, early stop on and off, with and without the
int8 cross cache, whose frame-major strides the arena keeps), one arena serving a
larger, a smaller and the larger shape again with nothing of an earlier
call left in the next, and the routing: only a model on a card with the
lineage table, no mesh and nothing being exported replays graphs; the
CPU, ``use_lineage=False``, greedy decoding and an exported program run
eagerly and replay nothing (``interface.decode_step_counts``), and each
counts its self K/V row writes as ``index_copy`` ones
(``interface.row_write_counts``; a replay credits what its capture took
back). The
finishing cases shift the decoder's final LayerNorm bias towards the
<eos> embedding row (the output projection is tied), so that every beam
finishes, and decode at alpha 0, where the early stop then ends the
search at 4-7 of its 10 steps; with random weights and alpha 1 it runs
them all."""

from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu_torch.config import get_config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data.features import extract_features  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data.synthetic import make_utterances  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.decoding import beam_decode, greedy_decode  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.decoding import beam_graph  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.decoding.beam import (  # noqa: E402
    EOS, eager_beam_search, replays_graphs, split_cache)
from speech_tranformer_pytorch_tpu_torch.decoding.beam_graph import (  # noqa: E402
    StepGraphs, graph_beam_search)
from speech_tranformer_pytorch_tpu_torch.kernels import interface  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.models import SpeechTransformer  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.recognize import Recognizer  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.serving import (  # noqa: E402
    export_recognizer, flatten_params, load_exported)

BEAM, MAX_LEN = 4, 10
FINISHING = [(0.0, 1.0), (7.0, 0.0)]   # (<eos> logit shift, alpha)


def _model(eos_shift: float = 0.0) -> SpeechTransformer:
    """The tiny preset's seeded model, every <eos> logit raised by about
    ``eos_shift``."""
    model = SpeechTransformer(get_config("tiny").model).init_weights(
        torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        row = model.decoder.embed.weight[EOS]
        model.decoder.final_norm.bias += eos_shift * row / row.dot(row)
    return model


def _memory(model, batch: int, frames: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(batch, frames, get_config("tiny").model.input_dim, generator=g)
    lens = torch.tensor([frames - 7 * i for i in range(batch)], dtype=torch.int32)
    with torch.no_grad():
        return model.encode(feats, lens)


def _assert_same(got, want):
    assert got.steps == want.steps
    assert torch.equal(got.tokens, want.tokens)
    assert torch.equal(got.lengths, want.lengths)
    assert torch.equal(got.scores, want.scores)


@pytest.mark.parametrize("int8_kv", [False, True])
@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("eos_shift,alpha", FINISHING)
def test_arena_step_equals_eager_search(early_stop, eos_shift, alpha, int8_kv):
    model = _model(eos_shift)
    memory, mem_lens = _memory(model, 3, 90, seed=1)
    kw = dict(beam_size=BEAM, max_len=MAX_LEN, alpha=alpha, early_stop=early_stop,
              int8_kv=int8_kv)
    want = eager_beam_search(model, memory, mem_lens, **kw)
    got = graph_beam_search(model, memory, mem_lens, **kw)
    _assert_same(got, want)
    if early_stop and eos_shift > 0.0:   # the flag the step computes stopped it
        assert want.steps < MAX_LEN
    else:
        assert want.steps == MAX_LEN


@pytest.mark.parametrize("int8_kv", [False, True])
def test_arena_views_keep_the_eager_cache_layout(monkeypatch, int8_kv):
    # The int8 cross K/V keep the encoder's frame-major strides; on a card a
    # product over another layout may take another kernel and other bits.
    model = _model()
    memory, mem_lens = _memory(model, 2, 70, seed=5)
    seen, original = {}, beam_graph.beam_step

    def recording(model_, const, *args, **kwargs):
        seen.update(const)
        return original(model_, const, *args, **kwargs)

    monkeypatch.setattr(beam_graph, "beam_step", recording)
    StepGraphs(torch.device("cpu")).search(model, memory, mem_lens, beam_size=BEAM,
                                           max_len=MAX_LEN, alpha=1.0, int8_kv=int8_kv,
                                           early_stop=True)
    eager = split_cache(model.init_cache(memory, MAX_LEN, BEAM, int8_kv))[0]
    assert set(seen) == set(eager)
    for layer, tensors in seen.items():
        assert {k: (t.shape, t.stride(), t.dtype) for k, t in tensors.items()} == {
            k: (t.shape, t.stride(), t.dtype) for k, t in eager[layer].items()}


def _poison(graphs: StepGraphs) -> None:
    """What an earlier call could leave: non-finite floats, stray ids, a
    set flag, in every buffer of the arena."""
    for buf in graphs._buffers.values():
        if buf.is_floating_point():
            buf.fill_(float("nan"))
        elif buf.dtype == torch.bool:
            buf.fill_(True)
        else:
            buf.fill_(3)


@pytest.mark.parametrize("eos_shift,alpha", FINISHING)
def test_one_arena_serves_larger_smaller_larger_with_nothing_left_over(eos_shift, alpha):
    model = _model(eos_shift)
    graphs = StepGraphs(torch.device("cpu"))
    shapes = [(3, 120, MAX_LEN, 11), (2, 60, 6, 12), (3, 120, MAX_LEN, 13)]
    ptrs = []
    for batch, frames, max_len, seed in shapes:
        memory, mem_lens = _memory(model, batch, frames, seed)
        kw = dict(beam_size=BEAM, max_len=max_len, alpha=alpha)
        got = graphs.search(model, memory, mem_lens, int8_kv=False, early_stop=True, **kw)
        _assert_same(got, eager_beam_search(model, memory, mem_lens, **kw))
        ptrs.append({name: buf.data_ptr() for name, buf in graphs._buffers.items()})
        _poison(graphs)
    assert ptrs[0] == ptrs[1] == ptrs[2]     # sized once, by the larger shape
    # A larger shape after a smaller one grows the arena, with no leak either.
    memory, mem_lens = _memory(model, 4, 150, 14)
    kw = dict(beam_size=BEAM, max_len=MAX_LEN + 2, alpha=alpha)
    got = graphs.search(model, memory, mem_lens, int8_kv=False, early_stop=True, **kw)
    _assert_same(got, eager_beam_search(model, memory, mem_lens, **kw))


@pytest.fixture(scope="module")
def served():
    cfg = get_config("tiny")
    params = SpeechTransformer(cfg.model).init_weights(
        torch.Generator().manual_seed(0)).state_dict()
    audio, lens = make_utterances(2, min_seconds=0.8, max_seconds=1.2, seed=3)
    rec = Recognizer(cfg, params, device="cpu")
    feats, frame_lens = extract_features(audio, lens, cfg.features, device="cpu")
    return cfg, params, rec, audio, lens, feats, frame_lens


def _decode(served, path: str) -> int:
    """Decode the served batch on ``path``; returns the steps run."""
    _, _, rec, audio, lens, feats, frame_lens = served
    if path == "recognizer_cpu":
        rec.decode_result(audio, lens, beam_size=BEAM, max_len=MAX_LEN, alpha=1.0)
        return rec.last_steps
    if path == "gathered_cache":
        return beam_decode(rec.model, feats, frame_lens, beam_size=BEAM, max_len=MAX_LEN,
                           device="cpu", use_lineage=False).steps
    return greedy_decode(rec.model, feats, frame_lens, max_len=MAX_LEN, device="cpu").steps


@pytest.mark.parametrize("path", ["recognizer_cpu", "gathered_cache", "greedy"])
def test_eager_paths_count_eager_steps_and_no_replay(served, path):
    interface.reset_decode_step_counts()
    steps = _decode(served, path)
    assert steps > 0
    assert interface.decode_step_counts() == {"captures": 0, "replays": 0,
                                              "eager_steps": steps,
                                              "prologue_captures": 0, "prologue_replays": 0,
                                              "prologue_eager": 0}


@pytest.mark.parametrize("path", ["recognizer_cpu", "gathered_cache", "greedy"])
def test_eager_paths_count_their_row_writes_as_index_copy(served, path):
    # On the CPU every route writes the self K/V rows with index_copy_: one
    # write a decoder layer and step; the kernel route is the card's alone.
    layers = served[0].model.num_decoder_layers
    interface.reset_row_write_counts()
    steps = _decode(served, path)
    assert interface.row_write_counts() == {"kernel": 0, "index_copy": layers * steps}


def test_a_replay_credits_the_row_writes_its_capture_took_back():
    before = interface.row_write_counts()
    interface.credit_row_writes({"kernel": 6}, -1)    # what a capture takes back
    graph = beam_graph._Graph(SimpleNamespace(replay=lambda: None), {}, {"kernel": 6})
    for _ in range(3):
        graph.replay()
    assert interface.row_write_counts() == {**before, "kernel": before["kernel"] + 12}
    interface.credit_row_writes({"kernel": 6}, -2)
    assert interface.row_write_counts() == before


def test_exported_program_captures_and_replays_nothing(served):
    cfg, params, rec, audio, lens, feats, frame_lens = served
    interface.reset_decode_step_counts()
    data = export_recognizer(cfg, params, batch_size=2, frames=feats.shape[1],
                             beam_size=BEAM, max_len=MAX_LEN, device="cpu")
    tokens, lengths, scores = load_exported(data)(flatten_params(params), feats,
                                                  frame_lens.to(torch.int32))
    # The exported loop is one while_loop: no Python step, no graph.
    assert interface.decode_step_counts() == {"captures": 0, "replays": 0,
                                              "eager_steps": 0,
                                              "prologue_captures": 0, "prologue_replays": 0,
                                              "prologue_eager": 0}
    live = beam_decode(rec.model, feats, frame_lens, beam_size=BEAM, max_len=MAX_LEN,
                       device="cpu", early_stop=False)
    assert torch.equal(tokens, live.tokens) and torch.equal(lengths, live.lengths)


def test_only_a_card_with_lineage_no_mesh_and_no_export_replays_graphs(monkeypatch):
    model = _model()
    card, cpu = torch.device("cuda"), torch.device("cpu")
    assert replays_graphs(model, card, MAX_LEN, use_lineage=True)
    assert not replays_graphs(model, cpu, MAX_LEN, use_lineage=True)
    assert not replays_graphs(model, card, MAX_LEN, use_lineage=False)
    assert not replays_graphs(model, card, 0, use_lineage=True)
    monkeypatch.setattr(model.decoder, "mesh", object())
    assert not replays_graphs(model, card, MAX_LEN, use_lineage=True)
    monkeypatch.setattr(model.decoder, "mesh", None)
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    assert not replays_graphs(model, card, MAX_LEN, use_lineage=True)


def test_a_capture_takes_its_launches_back_and_a_replay_credits_them():
    before = interface.launch_counts()
    step = {"lineage_attention": 3, "beam_prune": 1}
    interface.credit_launches(step)
    interface.credit_launches(step, 2)
    interface.credit_launches(step, -3)
    assert interface.launch_counts() == before
    interface.credit_launches(step, 2)
    after = interface.launch_counts()
    assert after["lineage_attention"] - before["lineage_attention"] == 6
    assert after["beam_prune"] - before["beam_prune"] == 2
    interface.credit_launches(step, -2)
