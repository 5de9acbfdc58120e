"""95th percentile of the per-call wall of ``decode_result`` over every
call of the window: host PCM in to hypotheses on the host."""

import statistics

UNIT, BETTER, SOURCE, KIND = "s", "lower", "host_clock", "end_to_end"


def read(record, ctx):
    walls = [it["wall_s"] for it in record.items if "wall_s" in it]
    if record.kind != "serve" or len(walls) < 20:
        return None
    return statistics.quantiles(walls, n=20, method="inclusive")[18]
