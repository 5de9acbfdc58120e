"""Host-side launch calls in the traced window over its train steps."""

UNIT, BETTER, SOURCE, KIND = "count", "lower", "device_trace", "per_layer"
LAYER, MOVES = "train step (train.make_train_step)", "train_audio_s_per_s"


def read(record, ctx):
    if record.kind != "train" or record.trace is None or record.trace.busy_s <= 0 or not record.items:
        return None
    return record.trace.launches / len(record.items)
