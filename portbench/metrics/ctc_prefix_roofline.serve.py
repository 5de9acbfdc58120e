"""Share of the CTC prefix scorer's roofline in the traced served calls:
the least time of every step of every call (``work/ctc.py``: from the
beam, the pre-beam, the step and each utterance's valid encoder frames)
over the device time of the kernels named below. Nothing to read where
no such kernel ran (an attention-only model, or a port without it)."""

from portbench.work.ctc import call_bound_s

UNIT, BETTER, SOURCE, KIND = "%", "higher", "device_trace", "per_layer"
LAYER, MOVES = "kernels (kernels/*)", "serve_audio_s_per_s"
KERNELS = ("ctc_prefix",)   # csrc/ctc_prefix.cu: ctc_prefix_kernel


def read(record, ctx):
    if record.kind != "serve" or record.trace is None:
        return None
    busy = record.trace.device_seconds(lambda n: any(k in n for k in KERNELS))
    if busy <= 0:
        return None
    bound = sum(call_bound_s(it["frames"], it["beam"], it["steps"]) for it in record.items)
    return 100.0 * bound / busy
