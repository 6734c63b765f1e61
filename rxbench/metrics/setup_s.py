"""Seconds from the start of the process to the start of the window: building,
loading, making the inputs and weights, warming every shape."""


def read(rec):
    return rec.get("setup_s")
