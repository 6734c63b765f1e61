"""K2-K4's share of their roofline in the traced steps: the sum over the
traced steps of each shear pass's least time (``shear_bounds`` on the
step's own shifts, drawn again from the seed) over the device time of the
three kernels (``shear_x_kernel``, ``shear_y_kernel``,
``shear_finish_kernel``) in the trace."""

from rxbench.reference.augment import draws, pass_shifts
from rxbench.trace import kernel_seconds
from rxbench.work.bounds import bound_ms, shear_bounds

KERNELS = ("shear_x_kernel", "shear_y_kernel", "shear_finish_kernel")


def read(rec):
    trace = rec.get("trace")
    if rec["mode"] != "train" or not trace or not rec["traced_steps"]:
        return None
    secs, launches = kernel_seconds(trace, lambda n: any(k in n for k in KERNELS))
    if secs <= 0 or launches != 3 * len(rec["traced_steps"]):
        return None
    t = rec["traffic"]
    views, src, crop, ch = t["bs_per_device"] * t["G"], t["src"], t["crop"], 6
    bound = 0.0
    for step in rec["traced_steps"]:
        passes = pass_shifts(draws(rec["seed"], step, views, src, crop), src, crop, ch,
                             rec["device"])
        kf = {name: (p["k"],) for name, p in zip(
            ("shear_pass", "shear_pass_rows", "shear_pass_finish"), passes)}
        work = shear_bounds(kf, [p["pads"] for p in passes], views * ch, src, src, crop)
        bound += sum(bound_ms(*w) for w in work.values()) / 1e3
    return 100.0 * bound / secs
