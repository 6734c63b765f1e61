"""rxpack reader and raw writer (counterpart of ``rxtpu/data/pack.py``).

Format, one pack per split:
  {out}/{split}.rxpack       consecutive (C, H, W) uint8 blocks, one per
                             (experiment, plate, well, site)
  {out}/{split}.rxpack.json  {"h", "w", "channels", "entries": {key: ordinal}}

``PackStore`` memory-maps a raw pack; a batch is a memcpy. Compressed packs
(``"compress"`` in the JSON) are not ported yet and raise.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np

from rxtpu_torch.data.records import WellRecord

ViewKey = Tuple[str, int, str, int]  # (experiment, plate, well, site)


def _key(experiment: str, plate: int, well: str, site: int) -> str:
    return f"{experiment}|{plate}|{well}|{site}"


def write_raw_pack(out_dir: str, split: str,
                   views: Iterable[Tuple[ViewKey, np.ndarray]]) -> str:
    """Write a raw pack from ``((experiment, plate, well, site), uint8 [C, H, W])``
    pairs, in the order given. Returns the pack path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{split}.rxpack")
    entries: Dict[str, int] = {}
    shape = None
    with open(path, "wb") as f:
        for ordinal, (key, view) in enumerate(views):
            view = np.ascontiguousarray(view, dtype=np.uint8)
            if shape is None:
                shape = view.shape
            if view.ndim != 3 or view.shape != shape:
                raise ValueError(f"view {key} has shape {view.shape}, expected {shape}")
            entries[_key(*key)] = ordinal
            f.write(view.tobytes())
    if shape is None:
        raise ValueError("no views to pack")
    c, h, w = shape
    with open(path + ".json", "w") as f:
        json.dump({"h": h, "w": w, "channels": c, "entries": entries}, f)
    return path


class PackStore:
    """Memory-mapped reader over a raw pack; the Pipeline's decoded store."""

    def __init__(self, pack_path: str):
        with open(pack_path + ".json") as f:
            meta = json.load(f)
        if meta.get("compress"):
            raise NotImplementedError(
                f"compressed packs ({meta['compress']!r}) are not ported yet; "
                "write the pack without --compress")
        self.h, self.w = meta["h"], meta["w"]
        self.n_channels = meta["channels"]
        self._entries = meta["entries"]
        self._mm = np.memmap(pack_path, dtype=np.uint8, mode="r")
        self._view_elems = self.n_channels * self.h * self.w

    def _ordinal(self, r: WellRecord, site: int) -> int:
        return self._entries[_key(r.experiment, r.plate, r.well, site)]

    def get_decoded_batch(self, keys: Sequence[Tuple[WellRecord, int]]) -> np.ndarray:
        """uint8 [len(keys), C, H, W] for (record, site) pairs."""
        out = np.empty((len(keys), self._view_elems), np.uint8)
        for i, (r, site) in enumerate(keys):
            off = self._ordinal(r, site) * self._view_elems
            out[i] = self._mm[off: off + self._view_elems]
        return out.reshape(len(keys), self.n_channels, self.h, self.w)
