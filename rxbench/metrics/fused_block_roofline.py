"""K6/K7's share of their roofline in the traced steps: the sum over the
traced steps of the 13 fused blocks' per-body least times (``fb_work``,
bytes against bf16 operations) over the device time of the fused block's
kernels (``pipe_gemm_kernel``, ``pipe_wgrad_kernel``,
``bn_backward_kernel`` and its own ``reduce_kernel``) in the trace."""

from rxbench.trace import kernel_seconds
from rxbench.work.bounds import fused_step_bound_ms

NAMES = ("pipe_gemm_kernel", "pipe_wgrad_kernel", "bn_backward_kernel")


def _fused(name):
    return any(k in name for k in NAMES) or ("reduce_kernel(" in name
                                             and "at::native" not in name)


def read(rec):
    trace = rec.get("trace")
    t = rec["traffic"]
    if rec["mode"] != "train" or not t.get("fuse_blocks") or not trace:
        return None
    secs, _ = kernel_seconds(trace, _fused)
    if secs <= 0 or not rec["traced_steps"]:
        return None
    bound = fused_step_bound_ms(t["bs_per_device"] * t["G"]) / 1e3 * len(rec["traced_steps"])
    return 100.0 * bound / secs
