"""Share of the traced stretch of a train window in which no operation ran on
the device: one minus the union of the trace's device intervals."""


def read(rec):
    if rec["mode"] != "train" or not rec.get("trace"):
        return None
    return 100.0 * (1.0 - rec["trace"]["busy_s"] / rec["trace"]["window_s"])
