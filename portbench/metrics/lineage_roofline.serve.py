"""Share of lineage attention's roofline in the traced served calls: the
least time of every call of it (``work/lineage.py``: each decoder layer
at every step run, from the batch, the beam, the cache position and the
ancestor rows the served hypotheses share) over the device time of the
kernel named below."""

from portbench.work.lineage import decode_call_bound_s

UNIT, BETTER, SOURCE, KIND = "%", "higher", "device_trace", "per_layer"
LAYER, MOVES = "kernels (kernels/*)", "serve_audio_s_per_s"
KERNELS = ("lineage_attention_kernel",)   # csrc/lineage_attention.cu


def read(record, ctx):
    if record.kind != "serve" or record.trace is None:
        return None
    busy = record.trace.device_seconds(lambda n: any(k in n for k in KERNELS))
    if busy <= 0:
        return None
    m = ctx.cfg["model"]
    bound = sum(decode_call_bound_s(m, it["b"], it["beam"], it["steps"], it["tokens"])
                for it in record.items)
    return 100.0 * bound / busy
