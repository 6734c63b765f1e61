"""K1's share of its roofline in the traced pass: each launch's least time
(``k1_bound_ms``: a batch's uint8 planes read, bf16 views written) over the
device time of ``crop_norm_kernel`` in the trace."""

from rxbench.trace import kernel_seconds
from rxbench.work.bounds import k1_bound_ms


def read(rec):
    trace = rec.get("trace")
    if rec["mode"] != "predict" or not trace:
        return None
    secs, launches = kernel_seconds(trace, lambda n: "crop_norm_kernel" in n)
    if secs <= 0:
        return None
    t = rec["traffic"]
    planes = t["bs_per_device"] * t["G"] * 6
    return 100.0 * launches * k1_bound_ms(planes, t["src"], 2) / 1e3 / secs
