"""Share of the traced window's device time (the union of the device
operations' intervals) taken by the CTC prefix scorer's kernels. Nothing
to read where none ran."""

UNIT, BETTER, SOURCE, KIND = "%", "lower", "device_trace", "per_layer"
LAYER, MOVES = "beam search (decoding/beam: CTC prefix scoring)", "serve_audio_s_per_s"
KERNELS = ("ctc_prefix",)   # csrc/ctc_prefix.cu: ctc_prefix_kernel


def read(record, ctx):
    if record.kind != "serve" or record.trace is None or record.trace.busy_s <= 0:
        return None
    busy = record.trace.device_seconds(lambda n: any(k in n for k in KERNELS))
    if busy <= 0:
        return None
    return 100.0 * busy / record.trace.busy_s
