"""The predict step's share of the chip's bf16 peak: the configuration's
forward FLOPs per full-size view (2 per multiply-add), times the views of
the window's passes outside its traced one, over those passes' host-clock
seconds and 989 TFLOP/s."""

from rxbench.peaks import BF16_FLOPS
from rxbench.trace import untraced
from rxbench.work.flops import view_flops


def read(rec):
    part = untraced(rec) if rec["mode"] == "predict" else None
    if part is None:
        return None
    views, seconds, _ = part
    t = rec["traffic"]
    return 100.0 * view_flops(rec["cfg"], t["src"], t["G"], False) * views / seconds / BF16_FLOPS
