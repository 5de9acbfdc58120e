"""Operation and byte counts: the kernel table's bounds (PERF.md, kernel
table) at its shapes, and the model FLOPs against a direct count."""

import pytest
import torch

from portbench.work import flash, lineage, model


def test_flash_forward_bound_at_the_kernel_table_shape():
    # B 64, H 8, T' 149, D 64, bf16; the lengths do not matter: bytes bound it.
    g = torch.Generator().manual_seed(3)
    lens = torch.randint(99, 150, (64,), generator=g).tolist()
    lens[0] = 149
    assert flash.bound_ms(64, 8, 149, 149, 64, lens, False, "fwd") == pytest.approx(0.01175, abs=5e-6)
    # dK/dV and dQ read more: their bounds are the table's rows 5 and 6.
    assert flash.bound_ms(64, 8, 149, 149, 64, lens, False, "dkv") == pytest.approx(0.01767, abs=5e-6)
    assert flash.bound_ms(64, 8, 149, 149, 64, lens, False, "dq") == pytest.approx(0.01476, abs=5e-6)


def _smoke_lineage_distinct() -> int:
    """Distinct K/V lanes the kernel table's timing case reads: the smoke
    check's draws, replayed on the same CPU generator in the same order."""
    b, g = 8, torch.Generator().manual_seed(2)

    def inputs(index, k=5, L=100, shared=False, h=8, d=64):
        torch.randn(b * k, 1, h, d, generator=g)
        torch.randn(b * k, L, h, d, generator=g)
        torch.randn(b * k, L, h, d, generator=g)
        lin = torch.randint(0, k, (b, k, L), generator=g, dtype=torch.int32)
        if shared:
            lin[:] = 0
        lin[:, :, index + shared:] = torch.arange(k, dtype=torch.int32)[None, :, None]
        return lin

    cases = [dict(index=i) for i in (0, 17, 49, 99)]
    cases += [dict(index=49, shared=True), dict(index=200, L=256)]
    cases += [dict(index=i, k=1) for i in (0, 31, 99)]
    cases += [dict(index=i, k=k, h=h, d=d) for h, d in ((16, 128), (4, 128))
              for k in (5, 1) for i in (0, 49, 99)]
    for _ in range(2):                      # float32, then bfloat16
        for kw in cases:
            inputs(**kw)
    inputs(0)                               # the timed cases: index 0, then 49
    lin = inputs(49)
    lanes = torch.zeros(b, 5, 50).scatter_(1, lin[:, :, :50].long(), 1.0)
    return int(lanes.sum())


def test_lineage_bound_at_the_kernel_table_shape():
    distinct = _smoke_lineage_distinct()
    assert lineage.bound_ms(40, 49, 8, 64, 2, distinct) == pytest.approx(0.000861, abs=5e-7)
    # Every lane of every position (the serving metric's count) reads more.
    assert lineage.bound_ms(40, 49, 8, 64, 2) > lineage.bound_ms(40, 49, 8, 64, 2, distinct)


def test_model_flops_count_every_product():
    m = dict(d_model=8, d_ff=16, subsample_channels=2, input_dim=11, num_encoder_layers=1,
             num_decoder_layers=1, vocab_size=10, num_heads=2)
    # frames 15 -> t1 7 -> t2 3; freq 11 -> 5 -> 2
    enc = (2 * 7 * 5 * 2 * 9 + 2 * 3 * 2 * 2 * 2 * 9 + 2 * 3 * 4 * 8
           + 2 * 3 * 8 * 24 + 4 * 3 * 3 * 8 + 2 * 3 * 8 * 8 + 4 * 3 * 8 * 16)
    assert model.encoder_flops(m, 15) == enc
    dec = (2 * 2 * 8 * 24 + 4 * 8 * 3 + 2 * 2 * 8 * 8 + 2 * 2 * 8 * 8 + 2 * 3 * 8 * 16
           + 4 * 8 * 2 * 3 + 2 * 2 * 8 * 8 + 4 * 2 * 8 * 16 + 2 * 2 * 8 * 10)
    assert model.decoder_flops(m, 2, 3) == dec
    assert model.train_step_flops(m, [15], [2]) == 3 * (enc + dec)
    # Decoding u steps on a beam of one does the teacher-forced work, but
    # projects the cross-attention cache once.
    call = model.serve_call_flops(m, [15], 1, 2)
    assert call == pytest.approx(enc + dec)
