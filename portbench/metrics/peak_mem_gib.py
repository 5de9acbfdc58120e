"""``torch.cuda.max_memory_allocated()`` over set-up and window, in GiB."""

UNIT, BETTER, SOURCE, KIND = "GiB", "lower", "device_trace", "end_to_end"


def read(record, ctx):
    return record.peak_bytes / 2 ** 30 if record.peak_bytes > 0 else None
