"""The port's decode-step contract (tiny preset, float32, CPU): every
caller hands ``Decoder.decode_step`` its step index as a 0-d int32 tensor
on the cache's device, and anything else is refused there, as the step
kernels' wrappers refuse it (``kernels/_build.index_ptr``); the eager
decode loop of beam search and of greedy search hands its step such an
index at every step; and the decode cache holds only each layer's
tensors. A card cache is stood in for by fake tensors on ``cuda``, which
the refusal reads no data of. The step's self-attention writes its K/V
row and attends in one call (``interface.lineage_attention_step``): over
several steps its logits and cache equal the route it replaced (an int64
index, ``index_copy_`` and the attend-only op) exactly, and while
``torch.export`` traces the step writes functional copies instead."""

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from speech_tranformer_pytorch_tpu_torch.config import get_config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.decoding import beam_search, greedy_search  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.kernels import _build, interface  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.models import SpeechTransformer  # noqa: E402

BEAM, MAX_LEN = 3, 6


@pytest.fixture(scope="module")
def model():
    return SpeechTransformer(get_config("tiny").model).init_weights(
        torch.Generator().manual_seed(0)).eval()


def _memory(model, batch: int = 2, frames: int = 60):
    g = torch.Generator().manual_seed(1)
    feats = torch.randn(batch, frames, get_config("tiny").model.input_dim, generator=g)
    lens = torch.tensor([frames - 9 * i for i in range(batch)], dtype=torch.int32)
    with torch.no_grad():
        return model.encode(feats, lens)


def _card_cache(model):
    """A cache whose tensors claim a card (fake: no data, no device)."""
    layer = model.decoder.layers[0].self_attn
    with FakeTensorMode():
        self_k = torch.empty((BEAM, MAX_LEN, layer.num_heads, layer.head_dim),
                             device="cuda")
    return {"layer_0": {"self_k": self_k}}


I32 = dict(dtype=torch.int32)
OFF_CONTRACT = [
    ("cpu_cache_python_int", "cpu", lambda: 0),
    ("cpu_cache_int64", "cpu", lambda: torch.tensor(0)),
    ("cpu_cache_1d", "cpu", lambda: torch.tensor([0], **I32)),
    ("card_cache_python_int", "cuda", lambda: 0),
    ("card_cache_cpu_index", "cuda", lambda: torch.tensor(0, **I32)),
]


@pytest.mark.parametrize("where,index", [c[1:] for c in OFF_CONTRACT],
                         ids=[c[0] for c in OFF_CONTRACT])
def test_decode_step_refuses_an_index_off_the_contract(model, where, index):
    if where == "cpu":
        memory, mem_lens = _memory(model, batch=1)
        cache = model.init_cache(memory, MAX_LEN, BEAM)
    else:
        cache, mem_lens = _card_cache(model), torch.tensor([60], **I32)
    tokens = torch.ones(BEAM, **I32)
    lineage = torch.zeros((1, BEAM, MAX_LEN), **I32)
    with pytest.raises(ValueError, match="0-d int32 tensor"), torch.no_grad():
        model.decode_step(tokens, index(), cache, mem_lens, BEAM, lineage)


@pytest.mark.parametrize("index", [lambda: 3, lambda: torch.tensor(3, **I32),
                                   lambda: torch.tensor(3)],
                         ids=["python_int", "cpu_int32", "cpu_int64"])
def test_step_kernels_refuse_an_index_off_the_card(index):
    with pytest.raises(ValueError, match="0-d int32 tensor"):
        _build.index_ptr(index(), torch.device("cuda", 0))


@pytest.mark.parametrize("search", ["beam", "greedy"])
def test_the_eager_loop_hands_every_step_a_device_index(model, monkeypatch, search):
    memory, mem_lens = _memory(model)
    seen, step = [], model.decode_step

    def recording(tokens, index, *args):
        seen.append(index)
        return step(tokens, index, *args)

    monkeypatch.setattr(model, "decode_step", recording)
    if search == "beam":
        steps = beam_search(model, memory, mem_lens, beam_size=BEAM, max_len=MAX_LEN,
                            early_stop=False).steps
    else:
        steps = greedy_search(model, memory, mem_lens, max_len=MAX_LEN,
                              early_stop=False).steps
    assert steps == len(seen) == MAX_LEN
    for n, index in enumerate(seen):
        assert torch.is_tensor(index) and index.dim() == 0
        assert index.dtype == torch.int32 and index.device == memory.device
        assert int(index) == n


@pytest.mark.parametrize("int8_kv", [False, True])
def test_init_cache_holds_only_the_layers(model, int8_kv):
    memory, _ = _memory(model)
    with torch.no_grad():
        cache = model.init_cache(memory, MAX_LEN, BEAM, int8_kv)
    n_layers = len(model.decoder.layers)
    assert list(cache) == [f"layer_{i}" for i in range(n_layers)]
    scales = {"cross_k_scale", "cross_v_scale"} if int8_kv else set()
    for layer in cache.values():
        assert set(layer) == {"self_k", "self_v", "cross_k", "cross_v"} | scales


def _parent_step(q_new, k_new, v_new, self_k, self_v, lineage, index, beam_width):
    """The step's self-attention as it was before the kernel wrote the rows:
    an int64 index, two ``index_copy_`` writes, then the attend-only op."""
    pos = index.reshape(1).long()
    self_k.index_copy_(1, pos, k_new)
    self_v.index_copy_(1, pos, v_new)
    return interface.lineage_attention(q_new, self_k, self_v, lineage, index, beam_width)


def _run_steps(model, beam, steps=5):
    """(logits of each step, the cache after them) of ``steps`` decode
    steps with a lineage table whose columns < i hold drawn parents."""
    memory, mem_lens = _memory(model)
    g = torch.Generator().manual_seed(4)
    cache = model.init_cache(memory, MAX_LEN, beam)
    rows = memory.shape[0] * beam
    lineage = torch.arange(beam, **I32)[None, :, None].expand(
        memory.shape[0], beam, MAX_LEN).contiguous()
    logits = []
    for i in range(steps):
        lineage[:, :, :i] = torch.randint(0, beam, (memory.shape[0], beam, i),
                                          generator=g, **I32)
        tokens = torch.randint(3, 20, (rows,), generator=g, **I32)
        with torch.no_grad():
            out, cache = model.decode_step(tokens, torch.tensor(i, **I32), cache,
                                           mem_lens, beam, lineage)
        logits.append(out)
    return logits, cache


@pytest.mark.parametrize("beam", [1, BEAM])
def test_decode_steps_equal_the_index_copy_route(model, monkeypatch, beam):
    got_logits, got_cache = _run_steps(model, beam)
    before = interface.row_write_counts()
    monkeypatch.setattr(interface, "lineage_attention_step", _parent_step)
    want_logits, want_cache = _run_steps(model, beam)
    assert interface.row_write_counts() == before   # the stand-in counts nothing
    for got, want in zip(got_logits, want_logits):
        assert torch.equal(got, want)
    for name, layer in want_cache.items():
        for key, t in layer.items():
            assert torch.equal(got_cache[name][key], t), (name, key)


def test_export_route_writes_functional_index_copy(model, monkeypatch):
    memory, mem_lens = _memory(model, batch=1)
    cache = model.init_cache(memory, MAX_LEN, BEAM)
    held = {n: (layer["self_k"], layer["self_v"]) for n, layer in cache.items()}
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)

    def refuse(*args):
        raise AssertionError("the export route wrote the cache in place")

    monkeypatch.setattr(interface, "lineage_attention_step", refuse)
    before = interface.row_write_counts()
    lineage = torch.arange(BEAM, **I32)[None, :, None].expand(1, BEAM, MAX_LEN)
    with torch.no_grad():
        _, out = model.decode_step(torch.ones(BEAM, **I32), torch.tensor(2, **I32), cache,
                                   mem_lens, BEAM, lineage)
    assert interface.row_write_counts() == before
    for name, (k, v) in held.items():
        assert not k.any() and not v.any()          # the carry is left as it was
        new_k = out[name]["self_k"]
        assert new_k is not k and new_k[:, 2].any()
        assert not new_k[:, :2].any() and not new_k[:, 3:].any()
