"""Share of the decode step's cross-attention roofline in the traced
served calls: the least time of every call of it (``work/cross.py``: each
decoder layer at every step run, from the beam and each utterance's valid
encoder frames) over the device time of the kernels named below. Nothing
to read where no such kernel ran (a port that takes the einsum route)."""

from portbench.work.cross import serve_bound_s

UNIT, BETTER, SOURCE, KIND = "%", "higher", "device_trace", "per_layer"
LAYER, MOVES = "kernels (kernels/*)", "serve_audio_s_per_s"
KERNELS = ("cross_attention_decode",)   # csrc/cross_attention.cu


def read(record, ctx):
    if record.kind != "serve" or record.trace is None:
        return None
    busy = record.trace.device_seconds(lambda n: any(k in n for k in KERNELS))
    if busy <= 0:
        return None
    m = ctx.cfg["model"]
    bound = sum(serve_bound_s(m, it["frames"], it["beam"], it["steps"]) for it in record.items)
    return 100.0 * bound / busy
