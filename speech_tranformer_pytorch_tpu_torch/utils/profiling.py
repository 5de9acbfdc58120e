"""Tracing and profiling (counterpart of the JAX package's
``utils/profiling.py``): a ``torch.profiler`` trace written as a Chrome
trace, the program's named spans on its timeline, a profile's device
operations, and what each span cost: host time, launch calls and the
device time those launches caused."""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
from typing import Dict, Iterable, Iterator, List, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

# Host-side calls that put work on the device's queue.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel", "cudaGraphLaunch")

_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace") -> Iterator[profile]:
    """Profile the block on the CPU and, where there is a card, on CUDA;
    writes ``<log_dir>/<name>.json`` (a Chrome trace, for chrome://tracing
    or Perfetto) when the block ends. Yields the profiler, whose
    ``events()`` and ``key_averages()`` the caller may read."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))


def named_scope(name: str):
    """A span named ``name`` on the profiler's host timeline, whose clock
    is the device events' own. While ``torch.export`` traces, and while no
    profiler runs, it is one shared context that does nothing: the checks
    read two flags and import nothing (the export flag first, since
    ``torch.export`` traces a loop's body with dynamo, which cannot trace
    the profiler's).

    The span is a plain host event, not a user annotation
    (``record_function``), so the profiler does not mirror it onto the
    device's timeline, where a reader of device events would take it for
    device work."""
    if torch.compiler.is_exporting() or not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast(name)


def busy_us(events) -> float:
    """Length of the union of the ``FunctionEvent`` intervals, in µs."""
    total, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in events):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_ops(prof) -> Tuple[List, float]:
    """A finished profile's device operations (kernels, copies, sets) as
    ``FunctionEvent``s, without the user-annotation spans the profiler
    mirrors onto the device's timeline, and their busy time in µs."""
    ops = [e for e in prof.events()
           if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    return ops, busy_us(ops)


@dataclasses.dataclass
class SpanStats:
    count: int = 0          # spans of the name
    host_s: float = 0.0     # their summed duration on the host
    launches: int = 0       # LAUNCH_CALLS inside them and in no deeper span
    device_s: float = 0.0   # device time of what their runtime calls enqueued


def span_stats(events: Iterable, prefix: str = "st.") -> Dict[str, SpanStats]:
    """What the program's spans (names starting with ``prefix``) cost, from
    a profile's kineto events (``prof.profiler.kineto_results.events()``).

    A runtime call (a host event named ``cu*``: launches, copies, sets,
    syncs) belongs to the innermost span open at its start on its own
    thread; a span's device time is that of the device operations whose
    correlation id is one of its calls'. Calls in no span, the device time
    they caused and the device time of no call among ``events`` are under
    ``""``, so the device times add up to the whole. The user annotations
    the profiler mirrors onto the device's timeline are not device
    operations."""
    spans: Dict[int, List[Tuple[int, int, str]]] = collections.defaultdict(list)
    calls: Dict[int, List[Tuple[int, str, int]]] = collections.defaultdict(list)
    device_ns: Dict[int, int] = collections.defaultdict(int)
    stats: Dict[str, SpanStats] = collections.defaultdict(SpanStats)
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device_ns[e.correlation_id()] += e.duration_ns()
        elif name.startswith(prefix):
            s = e.start_ns()
            spans[e.start_thread_id()].append((s, s + e.duration_ns(), name))
            stats[name].count += 1
            stats[name].host_s += e.duration_ns() / 1e9
        elif name.startswith("cu"):
            calls[e.start_thread_id()].append((e.start_ns(), name, e.correlation_id()))
    for thread, cs in calls.items():
        # Spans nest on a thread: sweep them outer first, with a stack.
        opened = sorted(spans.get(thread, ()), key=lambda sp: (sp[0], -sp[1]))
        stack: List[Tuple[int, int, str]] = []
        j = 0
        for t, name, corr in sorted(cs):
            while j < len(opened) and opened[j][0] <= t:
                while stack and stack[-1][1] <= opened[j][0]:
                    stack.pop()
                stack.append(opened[j])
                j += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            st = stats[stack[-1][2] if stack else ""]
            st.launches += name in LAUNCH_CALLS
            st.device_s += device_ns.pop(corr, 0) / 1e9
    if any(device_ns.values()):     # caused by no runtime call among the events
        stats[""].device_s += sum(device_ns.values()) / 1e9
    return dict(stats)
