"""Model FLOPs of the traced window's served calls of a Whisper
configuration (``work/whisper.py``: the stem, the encoder over every frame
of the window, the cross K/V projections, the prompt's first tokens and every
decode step run for every beam) over the window and the bf16 dense peak:
the cell's share of the whole step's peak, which ``serve.mfu`` (a
Speech-Transformer's count) is not. Nothing to read for a configuration
without ``features.kind`` 'whisper'."""

from portbench.peaks import BF16_FLOP_PER_S
from portbench.work.whisper import call_flops

UNIT, BETTER, SOURCE, KIND = "%", "higher", "device_trace", "per_layer"
LAYER, MOVES = "model step (models/*)", "serve_audio_s_per_s"


def read(record, ctx):
    if (record.kind != "serve" or record.trace is None or record.trace.busy_s <= 0
            or ctx.cfg["features"].get("kind") != "whisper"):
        return None
    flops = sum(call_flops(ctx.cfg, it) for it in record.items)
    return 100.0 * flops / (record.trace.window_s * BF16_FLOP_PER_S)
