"""The device's peak allocated memory over set-up and window, in GiB
(``torch.cuda.max_memory_allocated``, read before the reference runs)."""


def read(rec):
    if rec.get("peak_bytes") is None:
        return None
    return rec["peak_bytes"] / 2 ** 30
