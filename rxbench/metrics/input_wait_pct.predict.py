"""Share of the predict window, outside its traced pass, that the host spent
waiting for the test ``Pipeline``'s next batch inside ``predict_dataset``,
by the host clock."""

from rxbench.trace import untraced


def read(rec):
    part = untraced(rec) if rec["mode"] == "predict" else None
    if part is None:
        return None
    _, seconds, wait = part
    return 100.0 * wait / seconds
