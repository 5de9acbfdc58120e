"""CTC prefix scoring of beam candidates (one beam-search step's scorer of
the hybrid CTC/attention model).

The JAX package has no CTC head, so no TPU kernel is replaced: this is the
port's own kernel, ESPnet's ``CTCPrefixScore`` (Watanabe et al., 2017)
for every pre-beam candidate of every hypothesis at once. With x_t(k) the
CTC log-probs, ⊕ log-add-exp, T_b the utterance's valid frames, a
hypothesis g of length n with state (rⁿ_t, rᵇ_t) over its frames and last
token ℓ, and a candidate c:

- φ_t = rⁿ_t(g) ⊕ rᵇ_t(g), or rᵇ_t(g) alone when c = ℓ;
- rⁿ_0(g·c) = x_0(c) if n = 0, else log 0; rᵇ_0(g·c) = log 0;
  ψ = rⁿ_{s−1}(g·c) with s = max(n, 1);
- for t = s .. T_b − 1: rⁿ_t(g·c) = (rⁿ_{t−1}(g·c) ⊕ φ_{t−1}) + x_t(c),
  rᵇ_t(g·c) = (rⁿ_{t−1}(g·c) ⊕ rᵇ_{t−1}(g·c)) + x_t(blank),
  ψ ⊕= φ_{t−1} + x_t(c);
- for c = <eos>, ψ = rⁿ_{T_b−1}(g) ⊕ rᵇ_{T_b−1}(g), the probability of g
  as the whole transcript; for c = blank, ψ = log 0.

ψ is the log-probability that an alignment's labels begin with g·c. Every
state entry outside [s, T_b) is log 0 (``LOGZERO``), but rⁿ_0 = x_0(c)
when n = 0. The CUDA kernel (``csrc/ctc_prefix.cu``; its header says how
it parallelises the recursion along time) computes the same function.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

LOGZERO = -1e10    # ESPnet's ``logzero``: finite, so log 0 ⊕ log 0 is no NaN


def ctc_prefix_reference(
    logp: torch.Tensor,       # [B, V, T] f32 CTC log-probs, frames last
    state: torch.Tensor,      # [R, 2, T] f32 (rⁿ, rᵇ) of each hypothesis, R = B·beams
    last: torch.Tensor,       # [R] int32 each hypothesis's last token
    cand: torch.Tensor,       # [R, P] int32 candidate tokens
    index: torch.Tensor,      # n, every hypothesis's length: a 0-d int32 tensor
    lens: torch.Tensor,       # [B] int32 valid frames
    *,
    beams: int,
    blank: int = 0,
    eos: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (ψ [R, P] f32, the candidates' states [R, P, 2, T]),
    ESPnet's loop over frames."""
    r, p = cand.shape
    _, _, t_all = logp.shape
    n = int(index)
    utt = torch.arange(r, device=logp.device) // beams
    cand = cand.long()
    x = logp[utt[:, None], cand]                         # [R, P, T]
    xb = logp[utt, blank][:, None, :]                    # [R, 1, T]
    rn_g, rb_g = state[:, 0], state[:, 1]                # [R, T]
    same = (cand == last.long()[:, None])[..., None]     # [R, P, 1]
    phi = torch.where(same, rb_g[:, None], torch.logaddexp(rn_g, rb_g)[:, None])
    tb = lens.long()[utt][:, None]                       # [R, 1]
    s = max(n, 1)
    rn = torch.full((r, p, t_all), LOGZERO, device=logp.device)
    rb = torch.full_like(rn, LOGZERO)
    if n == 0:
        rn[..., 0] = x[..., 0]
    psi = x[..., 0].clone() if n == 0 else torch.full((r, p), LOGZERO, device=logp.device)
    for t in range(s, t_all):
        live = t < tb
        rn[..., t] = torch.where(live, torch.logaddexp(rn[..., t - 1], phi[..., t - 1])
                                 + x[..., t], LOGZERO)
        rb[..., t] = torch.where(live, torch.logaddexp(rn[..., t - 1], rb[..., t - 1])
                                 + xb[..., t], LOGZERO)
        psi = torch.where(live, torch.logaddexp(psi, phi[..., t - 1] + x[..., t]), psi)
    end = (tb - 1).clamp(min=0)
    whole = torch.logaddexp(rn_g.gather(1, end), rb_g.gather(1, end))   # [R, 1]
    psi = torch.where(cand == eos, whole, psi)
    psi = torch.where(cand == blank, torch.full_like(psi, LOGZERO), psi)
    return psi, torch.stack([rn, rb], 2)


def ctc_prefix_cuda(logp, state, last, cand, index, lens, *, beams: int, blank: int = 0,
                    eos: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper: same contract as ``ctc_prefix_reference`` for CUDA
    tensors, with ``index`` a 0-d int32 tensor on the log-probs' device,
    which the kernel reads there."""
    if logp.device.type != "cuda":
        raise ValueError("ctc_prefix_cuda needs CUDA tensors")
    b, v, t_all = logp.shape
    r, p = cand.shape
    if (logp.dtype != torch.float32 or state.dtype != torch.float32
            or tuple(state.shape) != (r, 2, t_all) or r != b * beams):
        raise ValueError(f"log-probs {tuple(logp.shape)} {logp.dtype}, states "
                         f"{tuple(state.shape)} {state.dtype} and candidates "
                         f"{tuple(cand.shape)} do not fit {beams} beams")
    if not (0 <= blank < v and 0 <= eos < v):
        raise ValueError(f"blank {blank} and eos {eos} must be ids below V={v}")
    dev = logp.device
    logp, state = logp.contiguous(), state.contiguous()
    last = last.to(torch.int32).contiguous()
    cand = cand.to(torch.int32).contiguous()
    lens = lens.to(torch.int32).contiguous()
    psi = torch.empty((r, p), dtype=torch.float32, device=dev)
    out = torch.empty((r, p, 2, t_all), dtype=torch.float32, device=dev)
    _build.check(_build.library().st_ctc_prefix(
        logp.data_ptr(), state.data_ptr(), last.data_ptr(), cand.data_ptr(),
        lens.data_ptr(), psi.data_ptr(), out.data_ptr(), r, p, beams, v, t_all,
        _build.index_ptr(index, dev), blank, eos, _build.stream_ptr(dev)), "st_ctc_prefix")
    ctc_prefix_cuda.launches += 1
    return psi, out


ctc_prefix_cuda.launches = 0
