"""Train views per second: every view of every step the window ran, over the
window's host-clock seconds (the window ends once the last step is done)."""


def read(rec):
    if rec["mode"] != "train":
        return None
    return rec["views"] / rec["window_s"]
