"""The train step's share of the chip's bf16 peak: the configuration's model
FLOPs per train view (2 per multiply-add, the backward twice the forward) at
the crop, times the views of the window's steps outside its traced stretch,
over those steps' host-clock seconds and 989 TFLOP/s."""

from rxbench.peaks import BF16_FLOPS
from rxbench.trace import untraced
from rxbench.work.flops import view_flops


def read(rec):
    part = untraced(rec) if rec["mode"] == "train" else None
    if part is None:
        return None
    views, seconds, _ = part
    t = rec["traffic"]
    return 100.0 * view_flops(rec["cfg"], t["crop"], t["G"], True) * views / seconds / BF16_FLOPS
