"""One reader per metric, found by the metric's name: ``<name>.py``.

A reader module sets ``UNIT``, ``BETTER``, ``SOURCE``, ``KIND``
(``end_to_end`` or ``per_layer``), for a per-layer metric ``LAYER`` and
``MOVES``, and defines ``read(record, ctx)``, which returns the value or
None when the run holds nothing to read. End-to-end readers read the
untraced run, per-layer readers the run with ``--trace 1``.
"""

from __future__ import annotations

import importlib.util
import os
from types import ModuleType

HERE = os.path.dirname(os.path.abspath(__file__))


def reader(name: str) -> ModuleType:
    path = os.path.join(HERE, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def idle_share_pct(record):
    """100 x (1 - busy / window) of the traced window."""
    t = record.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
