"""Share of the traced window in which no operation ran on the device:
1 - (union of the device operations' intervals) / window. Taken under the
profiler, which slows the host: it reads higher than the untraced window."""

from portbench.metrics import idle_share_pct

UNIT, BETTER, SOURCE, KIND = "%", "lower", "device_trace", "per_layer"
LAYER, MOVES = "device (H100)", "train_audio_s_per_s"


def read(record, ctx):
    return idle_share_pct(record) if record.kind == "train" else None
