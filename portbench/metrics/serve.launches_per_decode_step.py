"""Host-side launch calls in the traced window (``cudaLaunchKernel*``,
``cuLaunchKernel*``, ``cudaGraphLaunch``) over the decode steps the
window's calls ran (``Recognizer.last_steps``)."""

UNIT, BETTER, SOURCE, KIND = "count", "lower", "device_trace", "per_layer"
LAYER, MOVES = "decode loop (decoding/beam -> decode_step)", "serve_audio_s_per_s"


def read(record, ctx):
    steps = sum(it["steps"] for it in record.items)
    if record.kind != "serve" or record.trace is None or record.trace.busy_s <= 0 or steps == 0:
        return None
    return record.trace.launches / steps
