"""The benchmark's own profiler window and its reduction.

``traced()`` runs a block under ``torch.profiler`` (host and CUDA
activity) inside a ``portbench.window`` span; ``reduce`` turns the trace
into what the metric readers read: the device operations (kernels,
copies, sets) with their intervals, the host-side launch calls, the
window's length, the device's busy time (the union of the device
intervals inside the window), the device operations that took most time
and the idle gaps by what the host was doing (the innermost host event
open at the middle of each gap).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

WINDOW_SPAN = "portbench.window"
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel", "cudaGraphLaunch")


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, int, int]]     # (name, start ns, end ns), in the window
    launches: int                              # host launch calls in the window
    top_ops: List[list]                        # [[name, seconds], ...]
    idle_gaps: List[list]                      # [[host event, seconds], ...]

    def device_seconds(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.device_ops if match(n)) / 1e9


def union_ns(intervals) -> Tuple[float, List[Tuple[int, int]]]:
    """(length of the union of [start, end) intervals, the merged intervals)."""
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return float(sum(e - s for s, e in merged)), [(s, e) for s, e in merged]


@contextlib.contextmanager
def traced(enabled: bool, device) -> Iterator[list]:
    """Yields a list that holds the profiler once the block has ended (empty
    when ``enabled`` is false). Off a card only host activity is traced."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    box: list = []
    if not enabled:
        yield box
        return
    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            yield box
            if cuda:
                torch.cuda.synchronize(device)
    box.append(prof)


def _events(prof):
    """(name, is_device, start ns, end ns, thread) of every event."""
    from torch.autograd import DeviceType

    try:
        raw = prof.profiler.kineto_results.events()
        for e in raw:
            yield (e.name(), e.device_type() == DeviceType.CUDA, e.start_ns(),
                   e.start_ns() + e.duration_ns(), e.start_thread_id())
    except AttributeError:          # an older profiler: the slower event list
        for e in prof.events():
            yield (e.name, e.device_type == DeviceType.CUDA, int(e.time_range.start * 1e3),
                   int(e.time_range.end * 1e3), e.thread)


def reduce(prof, top: int = 10) -> Trace:
    host, device = [], []
    window: Optional[Tuple[int, int]] = None
    for name, is_dev, s, e, thread in _events(prof):
        if is_dev and name.startswith("portbench."):
            continue      # a host span mirrored onto the device's timeline
        if is_dev:
            device.append((name, s, e))
        else:
            host.append((s, e, name, thread))
            if name == WINDOW_SPAN:
                window = (s, e)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    w0, w1 = window
    device = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
    busy, merged = union_ns((s, e) for _, s, e in device)
    launches = sum(1 for s, _, n, _ in host if w0 <= s <= w1 and n in LAUNCH_CALLS)
    by_op: Dict[str, float] = collections.defaultdict(float)
    for n, s, e in device:
        by_op[n] += (e - s) / 1e9
    # Idle gaps, each named by the innermost host event open at its middle
    # (the one that started last), on any thread: the autograd engine
    # launches the backward from a thread of its own.
    spans = sorted((s, e, n) for s, e, n, _ in host if n != WINDOW_SPAN)
    starts = [s for s, _, _ in spans]
    long_spans = [sp for sp in spans if sp[1] - sp[0] > 1_000_000]
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    by_host: Dict[str, float] = collections.defaultdict(float)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        name = None
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 200, -1), -1):
            if spans[j][1] >= mid:
                name = spans[j][2]
                break
        if name is None:
            inside = [sp for sp in long_spans if sp[0] <= mid <= sp[1]]
            name = inside[-1][2] if inside else "host Python, no op open"
        by_host[name] += (b - a) / 1e9
    rank = lambda d: [[n[:160], v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, device_ops=device,
                 launches=launches, top_ops=rank(by_op), idle_gaps=rank(by_host))
