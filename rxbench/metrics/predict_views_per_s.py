"""Predict views per second: every view of every answer the window's passes
returned, over the window's host-clock seconds."""


def read(rec):
    if rec["mode"] != "predict":
        return None
    return rec["views"] / rec["window_s"]
