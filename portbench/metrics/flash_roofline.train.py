"""Share of the flash kernels' roofline in the traced train steps: the
least time of every forward, dK/dV and dQ call the steps make
(``work/flash.py``, from their shapes and valid lengths) over the device
time of the kernels named below."""

from portbench.work.flash import train_step_bound_s

UNIT, BETTER, SOURCE, KIND = "%", "higher", "device_trace", "per_layer"
LAYER, MOVES = "kernels (kernels/*)", "train_audio_s_per_s"
KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")   # csrc/flash_attention.cu


def read(record, ctx):
    if record.kind != "train" or record.trace is None:
        return None
    busy = record.trace.device_seconds(lambda n: any(k in n for k in KERNELS))
    if busy <= 0:
        return None
    m = ctx.cfg["model"]
    bound = sum(train_step_bound_s(m, it["frames_pad"], it["frames"], it["u_pad"],
                                   it["target_lens"]) for it in record.items)
    return 100.0 * bound / busy
