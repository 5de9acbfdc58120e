"""The decode step's cross-attention (port ``kernels/cross_attention.py``):
the plain version is the route ``MultiHeadAttention.attend_bhsd`` took
before the kernel, bit for bit, on float32 and bfloat16 caches with ragged
lengths (K 1 and 5, S not a multiple of any split, H 8 and 4, D 64 and
128); an utterance with no valid frame takes uniform weights; the kernel
wrapper refuses what the kernel does not take; the custom op's fake
implementation gives the kernel's shape and strides; the cross cache is
kept in the compute dtype (int8 unchanged), and so is the beam graph's
arena. The CUDA kernel itself is held to the plain version on the card by
``chip_smoke.py --phases check_cross_attention``."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu_torch.config import get_config  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.decoding.beam_graph import StepGraphs  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.kernels import custom_ops, interface  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.kernels.cross_attention import (  # noqa: E402
    MAX_SPLITS, cross_attention_decode_cuda, cross_attention_decode_reference, splits_for)
from speech_tranformer_pytorch_tpu_torch.models import SpeechTransformer  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.models.modules import MultiHeadAttention  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.ops import masks  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (B, K, H, D, S): K 1 and 5, H 8 and 4, D 64 and 128, S prime or odd, so
# no split divides it.
SHAPES = [(3, 5, 8, 64, 37), (2, 1, 8, 64, 101), (2, 5, 4, 128, 53), (3, 1, 4, 128, 29)]


def _old_attend_bhsd(attn, q_in, k, v, bias):
    """``MultiHeadAttention.attend_bhsd`` as it ran before the kernel, with
    its caller's fold of the K beams into query rows (q_in [B, K, d])."""
    q = attn.project_q(q_in)                              # [B,T,H,D]
    qb = q.transpose(1, 2)                                # [B,H,T,D]
    scores = torch.einsum("bhtd,bhsd->bhts", qb.float(), k.float())
    scores = scores / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias.float()
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhts,bhsd->bhtd", weights, v)
    return attn.project_out(out.transpose(1, 2))


def _case(dtype, b, k, h, d, s, seed=0):
    g = torch.Generator().manual_seed(seed)
    attn = MultiHeadAttention(h * d, h)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    attn = attn.to(dtype)
    x = torch.randn(b * k, 1, h * d, generator=g).to(dtype)
    ck = torch.randn(b, h, s, d, generator=g).to(dtype)
    cv = torch.randn(b, h, s, d, generator=g).to(dtype)
    lens = torch.randint(1, s + 1, (b,), generator=g, dtype=torch.int32)
    lens[0] = s
    return attn, x, ck, cv, lens


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda t: "B{}K{}H{}D{}S{}".format(*t))
def test_plain_version_is_the_route_before_the_kernel(dtype, shape):
    b, k, h, d, s = shape
    attn, x, ck, cv, lens = _case(DTYPES[dtype], *shape)
    # The old cache kept cross_k in float32: the same values as the
    # compute-dtype keys the step now reads.
    bias = masks.mask_to_bias(masks.padding_attention_mask(1, lens.long(), s))
    with torch.no_grad():
        want = _old_attend_bhsd(attn, x.reshape(b, k, h * d), ck.float(), cv, bias)
        got = attn.attend_bhsd(x, ck, cv, lens)
    assert got.dtype == want.dtype and got.shape == (b * k, 1, h * d)
    assert torch.equal(got.reshape(b, k, h * d), want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_the_cache_in_frame_major_strides_gives_the_same_bits(dtype):
    # The int8 path dequantises a cache whose [B, H, S, D] view keeps the
    # encoder's [B, S, H, D] storage.
    _, x, ck, cv, lens = _case(DTYPES[dtype], 2, 5, 4, 64, 41, seed=3)
    q = x.reshape(10, 1, 4, 64)
    fm = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (ck, cv)]
    assert fm[0].stride() != ck.stride()
    assert torch.equal(cross_attention_decode_reference(q, *fm, lens),
                       cross_attention_decode_reference(q, ck, cv, lens))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_an_utterance_with_no_valid_frame_takes_uniform_weights(dtype):
    dt = DTYPES[dtype]
    g = torch.Generator().manual_seed(1)
    b, k, h, d, s = 2, 5, 4, 64, 23
    q = (torch.randn(b * k, 1, h, d, generator=g) * 0.01).to(dt)   # |scores| < 32
    ck, cv = (torch.randn(b, h, s, d, generator=g).to(dt) for _ in range(2))
    lens = torch.tensor([s, 0], dtype=torch.int32)
    got = cross_attention_decode_reference(q, ck, cv, lens)
    uniform = torch.full((h, k, s), 1.0 / s).to(dt)
    want = torch.einsum("hts,hsd->htd", uniform, cv[1]).transpose(0, 1)
    assert torch.equal(got.reshape(b, k, h, d)[1], want)
    assert torch.isfinite(got.float()).all()


def test_the_interface_runs_the_plain_version_on_the_cpu_and_counts_nothing():
    _, x, ck, cv, lens = _case(torch.float32, 3, 5, 8, 64, 37)
    q = x.reshape(15, 1, 8, 64)
    before = interface.launch_counts()
    got = interface.cross_attention_decode(q, ck, cv, lens)
    assert interface.launch_counts() == before
    assert torch.equal(got, cross_attention_decode_reference(q, ck, cv, lens))
    assert "cross_attention_decode" in before


def test_replays_credit_the_kernel_as_the_other_step_kernels():
    before = interface.launch_counts()
    interface.credit_launches({"cross_attention_decode": 6}, 3)
    assert interface.launch_counts()["cross_attention_decode"] - before[
        "cross_attention_decode"] == 18
    interface.credit_launches({"cross_attention_decode": 6}, -3)
    assert interface.launch_counts() == before


def _good(dt=torch.bfloat16, b=2, k=5, h=4, d=64, s=31):
    return [torch.zeros(b * k, 1, h, d, dtype=dt), torch.zeros(b, h, s, d, dtype=dt),
            torch.zeros(b, h, s, d, dtype=dt), torch.full((b,), s, dtype=torch.int32)]


@pytest.mark.parametrize("name,change,match", [
    ("float16", lambda a: [t.half() if t.is_floating_point() else t for t in a], "share"),
    ("mixed dtypes", lambda a: [a[0].float()] + a[1:], "share"),
    ("nine beams", lambda a: [torch.zeros(18, 1, 4, 64, dtype=a[0].dtype)] + a[1:], "K in"),
    ("q not [B*K, 1, H, D]", lambda a: [a[0].reshape(10, 4, 1, 64)] + a[1:], "K in"),
    ("v unlike k", lambda a: a[:2] + [a[2][:, :, :30]] + a[3:], "expected"),
    ("int64 lengths", lambda a: a[:3] + [a[3].long()], "int32"),
    ("D off the 16-byte grid", lambda a: [t[..., :60] if t.dim() == 4 else t for t in a],
     "multiple of"),
    ("the CPU", lambda a: a, "CUDA"),
])
def test_the_kernel_wrapper_refuses_what_the_kernel_does_not_take(name, change, match):
    with pytest.raises(ValueError, match=match):
        cross_attention_decode_cuda(*change(_good()))


def test_the_split_is_chosen_from_the_call_within_the_cluster_size():
    assert splits_for(128, 749, 132) >= 1
    assert all(1 <= splits_for(bh, s, sms) <= MAX_SPLITS
               for bh in (8, 64, 128, 1024) for s in (1, 49, 749, 5000) for sms in (1, 132))
    assert splits_for(8, 5000, 132) > splits_for(1024, 5000, 132)


def test_the_fake_implementation_gives_the_kernels_shape_and_strides():
    from torch._subclasses.fake_tensor import FakeTensorMode

    args = _good()
    torch.library.opcheck(custom_ops.cross_attention_decode, tuple(args))
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(t) for t in args]
        out = custom_ops.cross_attention_decode(*fake)
    assert out.shape == args[0].shape and out.dtype == args[0].dtype
    assert out.stride() == args[0].contiguous().stride()


def _tiny_model(dtype):
    cfg = get_config("tiny")
    model = SpeechTransformer(cfg.model).init_weights(torch.Generator().manual_seed(0))
    return model.to(dtype).eval(), cfg


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_the_cross_cache_stays_in_the_compute_dtype(dtype):
    model, cfg = _tiny_model(DTYPES[dtype])
    memory = torch.randn(2, 30, cfg.model.d_model).to(DTYPES[dtype])
    with torch.no_grad():
        cache = model.decoder.init_cache(memory, 6, 3)
        int8 = model.decoder.init_cache(memory, 6, 3, int8_kv=True)
    for i in range(cfg.model.num_decoder_layers):
        layer = cache[f"layer_{i}"]
        assert layer["cross_k"].dtype == layer["cross_v"].dtype == DTYPES[dtype]
        assert layer["cross_k"].is_contiguous() and layer["cross_v"].is_contiguous()
        assert int8[f"layer_{i}"]["cross_k"].dtype == torch.int8
        assert int8[f"layer_{i}"]["cross_k_scale"].dtype == DTYPES[dtype]


def test_the_beam_graph_arena_holds_no_float32_cross_keys():
    model, cfg = _tiny_model(torch.bfloat16)
    g = torch.Generator().manual_seed(2)
    feats = torch.randn(2, 60, cfg.model.input_dim, generator=g)
    with torch.no_grad():
        memory, mem_lens = model.encode(feats.to(torch.bfloat16),
                                        torch.tensor([60, 45], dtype=torch.int32))
    graphs = StepGraphs(torch.device("cpu"))
    graphs.search(model, memory, mem_lens, beam_size=3, max_len=4, alpha=1.0,
                  int8_kv=False, early_stop=False)
    (spec,) = graphs._specs.values()
    cross = {n: layout for n, layout in spec.items() if ".cross_" in n}
    assert cross and all(dtype == torch.bfloat16 for _, _, dtype in cross.values())
    assert spec["mem_lens"][2] == torch.int32
    assert not any(".cross_" in n and dt == torch.float32 for n, dt in graphs._buffers)


def test_a_decode_step_matches_the_step_before_the_kernel():
    """The whole decoder step (every layer, the K beams folded into query
    rows) through ``Decoder.decode_step`` against the old route, float32."""
    model, cfg = _tiny_model(torch.float32)
    dec = model.decoder
    g = torch.Generator().manual_seed(4)
    b, k, max_len = 2, 3, 5
    memory = torch.randn(b, 40, cfg.model.d_model, generator=g)
    mem_lens = torch.tensor([40, 27])
    tokens = torch.randint(3, cfg.model.vocab_size, (b * k,), generator=g)
    lineage = torch.arange(k, dtype=torch.int32)[None, :, None].expand(b, k, max_len).clone()
    with torch.no_grad():
        step0 = torch.tensor(0, dtype=torch.int32)
        got, _ = dec.decode_step(tokens, step0, dec.init_cache(memory, max_len, k), mem_lens,
                                 k, lineage)
        # The old route: cross_k in float32, the bias made once a step.
        cache = dec.init_cache(memory, max_len, k)
        for i in range(len(dec.layers)):
            cache[f"layer_{i}"]["cross_k"] = cache[f"layer_{i}"]["cross_k"].float()
        bias = masks.mask_to_bias(masks.padding_attention_mask(1, mem_lens, 40))
        try:
            for layer in dec.layers:
                attn = layer.cross_attn
                attn.attend_bhsd = (lambda a: lambda h, ck, cv, lens: _old_attend_bhsd(
                    a, h.reshape(b, k, -1), ck, cv, bias).reshape(b * k, 1, -1))(attn)
            want, _ = dec.decode_step(tokens, step0, cache, mem_lens, k, lineage)
        finally:
            for layer in dec.layers:
                del layer.cross_attn.attend_bhsd
    assert torch.equal(got, want)
    assert np.isfinite(got.numpy()).all()
