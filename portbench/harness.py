"""What every driver shares: the run's context, its record, and the
comparisons that decide ``correct``."""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
from typing import Any, Dict, List

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


def load_json(*parts) -> Any:
    with open(os.path.join(ROOT, *parts), encoding="utf-8") as f:
        return json.load(f)


@dataclasses.dataclass
class Context:
    cell: str
    config: dict                 # the configuration file (``config`` holds the port's dict)
    mix: dict                    # the traffic mix
    limits: dict                 # the limits of the compared numbers
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float               # host clock at process start

    @property
    def cfg(self) -> dict:
        return self.config["config"]

    def mark(self, what: str) -> None:
        """Note on standard error how far set-up has come."""
        import sys
        import time

        print(f"portbench: {what} at {time.perf_counter() - self.t_start:.3f} s",
              file=sys.stderr, flush=True)


@dataclasses.dataclass
class Record:
    """What a driver hands back: the window's items (one per call or step,
    each a dict with ``wall_s``, ``audio_s`` and its shapes), the set-up and
    window times, the memory peak, the trace and the compared numbers."""
    kind: str
    setup_s: float
    window_s: float
    items: List[dict]
    peak_bytes: int
    attempted: int
    failed: int
    numbers: Dict[str, float]
    trace: Any = None

    def checks(self, limits: dict) -> List[dict]:
        return [{"name": k, "value": v, "limit": limits.get(k)} for k, v in self.numbers.items()]

    def correct(self, limits: dict) -> bool:
        if self.failed or not self.numbers:
            return False
        for c in self.checks(limits):
            if c["limit"] is None or not math.isfinite(c["value"]) or c["value"] > c["limit"]:
                return False
        return True


def port_config(cfg: dict):
    """The port's ``ExperimentConfig`` of a configuration dictionary."""
    from speech_tranformer_pytorch_tpu_torch.config import config_from_dict

    return config_from_dict(cfg).validate()


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free_device(device: torch.device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------------
# Compared numbers.
# ----------------------------------------------------------------------------

def score_gaps(program: torch.Tensor, reference: torch.Tensor) -> List[float]:
    """Gaps between the served scores and the reference's scores of the
    same hypotheses (length-penalised log-probabilities, in nats)."""
    p, r = (t.detach().double().cpu().flatten() for t in (program, reference))
    return (p - r).abs().tolist()


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keys) -> float:
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def train_numbers(losses_p, losses_r, grad_p: Dict[str, torch.Tensor],
                  grad_r: Dict[str, torch.Tensor], params0: Dict[str, torch.Tensor],
                  params_p: Dict[str, torch.Tensor], params_r: Dict[str, torch.Tensor]
                  ) -> Dict[str, float]:
    """``loss_gap``: the widest relative gap of the steps' losses;
    ``grad_gap``: of the first step's clipped gradient norms, leaf by leaf
    against the larger of the leaf's and the median leaf's reference norm;
    ``change_gap``: the same for the norm of the parameters' change over
    the steps, taken over the elements whose reference gradient is at least
    a thousandth of the median leaf's root-mean-square gradient. The others
    (a key's bias under softmax: its gradient is nought to rounding) move
    under Adam by round-off alone; a leaf with none left is left out."""
    norm = lambda t: float(t.double().norm())
    keys = list(grad_r)
    gp = {k: norm(grad_p[k]) for k in keys}
    gr = {k: norm(grad_r[k]) for k in keys}
    floor = 1e-3 * statistics.median(gr[k] / math.sqrt(grad_r[k].numel()) for k in keys)
    cp, cr = {}, {}
    for k in keys:
        live = grad_r[k].cpu().abs() >= floor
        if bool(live.any()):
            p0 = params0[k].cpu().double()[live]
            cp[k] = norm(params_p[k].cpu().double()[live] - p0)
            cr[k] = norm(params_r[k].cpu().double()[live] - p0)
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses_p, losses_r)),
            "grad_gap": _leaf_gap(gp, gr, keys),
            "change_gap": _leaf_gap(cp, cr, list(cp))}
