"""Share of a served Whisper call's roofline in the traced window: the
sum over the traced calls of each part's least time (``work/whisper.py``:
the prologue, then every decode step at its position, each the larger of
its FLOPs over the bf16 peak and its minimal bytes over the HBM
bandwidth) over the traced device-busy time. It reads below 100 % by
construction; a decode step bound by its bytes (the decoder's weights,
the cross cache, the tied table) moves it most. Nothing to read for a
configuration without ``features.kind`` 'whisper'."""

from portbench.work.whisper import call_bound_s

UNIT, BETTER, SOURCE, KIND = "%", "higher", "device_trace", "per_layer"
LAYER, MOVES = "model step (models/*)", "serve_audio_s_per_s"


def read(record, ctx):
    if (record.kind != "serve" or record.trace is None or record.trace.busy_s <= 0
            or ctx.cfg["features"].get("kind") != "whisper"):
        return None
    return 100.0 * sum(call_bound_s(ctx.cfg, it) for it in record.items) / record.trace.busy_s
