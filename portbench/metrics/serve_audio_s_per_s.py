"""Audio seconds of every batch ``decode_result`` completed in the window,
over the window (which ends at a device synchronisation)."""

UNIT, BETTER, SOURCE, KIND = "audio-s/s", "higher", "host_clock", "end_to_end"


def read(record, ctx):
    if record.kind != "serve" or not record.items:
        return None
    return sum(it["audio_s"] for it in record.items) / record.window_s
