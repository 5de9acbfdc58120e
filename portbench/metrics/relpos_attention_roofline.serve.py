"""Share of the Conformer's relative-position attention roofline in the
traced served calls: the least time of every call of it
(``work/conformer.py``: one call an encoder layer, from each utterance's
valid encoder frames) over the device time of the kernels named below.
Nothing to read where no such kernel ran (a port without it)."""

from portbench.work.conformer import serve_relpos_bound_s

UNIT, BETTER, SOURCE, KIND = "%", "higher", "device_trace", "per_layer"
LAYER, MOVES = "kernels (kernels/*)", "serve_audio_s_per_s"
KERNELS = ("relpos_attention",)   # csrc/relpos_attention.cu


def read(record, ctx):
    if record.kind != "serve" or record.trace is None:
        return None
    busy = record.trace.device_seconds(lambda n: any(k in n for k in KERNELS))
    if busy <= 0:
        return None
    m = ctx.cfg["model"]
    return 100.0 * sum(serve_relpos_bound_s(m, it["frames"]) for it in record.items) / busy
