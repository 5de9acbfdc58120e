"""Process start to the first timed call: imports, the kernels' build
cache, the weights from the seed, the host batches and the warm-up of
every shape of the cell."""

UNIT, BETTER, SOURCE, KIND = "s", "lower", "host_clock", "end_to_end"


def read(record, ctx):
    return record.setup_s
