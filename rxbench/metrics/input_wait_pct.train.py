"""Share of the train window, outside its traced stretch, that the host spent
in ``next()`` of the prefetch iterator (``device_prefetch`` over
``Pipeline.epoch``), by the host clock."""

from rxbench.trace import untraced


def read(rec):
    part = untraced(rec) if rec["mode"] == "train" else None
    if part is None:
        return None
    _, seconds, wait = part
    return 100.0 * wait / seconds
