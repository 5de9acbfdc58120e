"""Audio seconds of every train step completed in the window, over the
window (which ends at a device synchronisation; each batch's
host-to-device copy is inside it)."""

UNIT, BETTER, SOURCE, KIND = "audio-s/s", "higher", "host_clock", "end_to_end"


def read(record, ctx):
    if record.kind != "train" or not record.items:
        return None
    return sum(it["audio_s"] for it in record.items) / record.window_s
