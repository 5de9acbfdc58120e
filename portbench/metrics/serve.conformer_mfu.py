"""Model FLOPs of the traced window's served calls of a Conformer
configuration (``work/conformer.py``: the Conformer encoder on valid
lengths; the cross-attention cache and every decode step run for every
beam from ``work/model.py``) over the window and the bf16 dense peak: the
cell's share of the whole step's peak, which ``serve.mfu`` (a Transformer
encoder's count) is not. Nothing to read for a configuration without
``model.encoder`` 'conformer'."""

from portbench.peaks import BF16_FLOP_PER_S
from portbench.work.conformer import serve_call_flops

UNIT, BETTER, SOURCE, KIND = "%", "higher", "device_trace", "per_layer"
LAYER, MOVES = "model step (models/*)", "serve_audio_s_per_s"


def read(record, ctx):
    m = ctx.cfg["model"]
    if (record.kind != "serve" or record.trace is None or record.trace.busy_s <= 0
            or m.get("encoder") != "conformer"):
        return None
    flops = sum(serve_call_flops(m, it["frames"], it["beam"], it["steps"])
                for it in record.items)
    return 100.0 * flops / (record.trace.window_s * BF16_FLOP_PER_S)
