"""Model FLOPs of the traced window's served calls (``work/model.py``:
encoder on valid lengths, cross-attention cache, every decode step run
for every beam) over the window and the bf16 dense peak."""

from portbench.peaks import BF16_FLOP_PER_S
from portbench.work.model import serve_call_flops

UNIT, BETTER, SOURCE, KIND = "%", "higher", "device_trace", "per_layer"
LAYER, MOVES = "model step (models/*)", "serve_audio_s_per_s"


def read(record, ctx):
    if record.kind != "serve" or record.trace is None or record.trace.busy_s <= 0:
        return None
    m = ctx.cfg["model"]
    flops = sum(serve_call_flops(m, it["frames"], it["beam"], it["steps"])
                for it in record.items)
    return 100.0 * flops / (record.trace.window_s * BF16_FLOP_PER_S)
