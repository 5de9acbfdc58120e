"""Model FLOPs of the traced window's train steps (``work/model.py``:
three forwards on valid lengths, no recompute) over the window and the
bf16 dense peak."""

from portbench.peaks import BF16_FLOP_PER_S
from portbench.work.model import train_step_flops

UNIT, BETTER, SOURCE, KIND = "%", "higher", "device_trace", "per_layer"
LAYER, MOVES = "model step (models/*)", "train_audio_s_per_s"


def read(record, ctx):
    if record.kind != "train" or record.trace is None or record.trace.busy_s <= 0:
        return None
    m = ctx.cfg["model"]
    flops = sum(train_step_flops(m, it["frames"], it["target_lens"]) for it in record.items)
    return 100.0 * flops / (record.trace.window_s * BF16_FLOP_PER_S)
