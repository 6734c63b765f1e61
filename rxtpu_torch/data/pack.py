"""rxpack reader and writers (counterpart of ``rxtpu/data/pack.py``).

Format, one pack per split:
  {out}/{split}.rxpack       consecutive (C, H, W) uint8 blocks, one per
                             (experiment, plate, well, site)
  {out}/{split}.rxpack.json  {"h", "w", "channels", "entries": {key: ordinal}}

Compressed variant (``write_pack(compress="zlib"|"zstd")``): each view is
one variable-length stream, located by ``"offsets"`` and ``"lengths"``
(indexed by ordinal), with ``"compress"`` naming the codec; ``filter="png"``
row-filters every plane with the PNG filters before the codec (``"filter":
"png"``), which about doubles the ratio on smooth microscopy planes.

``PackStore`` memory-maps a pack: a raw batch is a memcpy, a compressed one
inflates (and unfilters) in one native pool call (``data/decode.py``).
``write_pack`` decodes every (well, site) of a JPEG or PNG tree once and
writes the pack, rxtpu's bytes; ``write_raw_pack`` writes a raw pack from
views in memory.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch

from rxtpu_torch.data.decode import (
    decode_files, deflate_filtered_batch, image_size, inflate_batch, inflate_unfilter_batch,
    load_codec,
)
from rxtpu_torch.data.records import MetadataIndex, WellRecord, all_records, image_path

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


def write_pack(index: MetadataIndex, img_dir: str, out_dir: str, ext: str = "jpeg",
               channels: Sequence[int] = (1, 2, 3, 4, 5, 6), src_size: int = None,
               decoder_threads: int = 0, batch_wells: int = 64, verbose: bool = False,
               compress: str = None, compress_level: int = 6, filter: str = None,
               device="cpu") -> str:
    """Decode every (well, site) of the index once and write the pack; returns
    its path.

    Reads ``{img_dir}/{split}/.../*.{ext}`` in batches of ``batch_wells``
    wells, strictly (a corrupt source raises instead of landing in the pack as
    zeros). JPEGs decode on ``device`` (nvJPEG on a card, so its planes, not
    libjpeg's), PNGs on the host whatever the device. ``compress="zlib"`` or
    ``"zstd"`` writes the compressed variant at ``compress_level`` (zlib 1-9,
    zstd 1-22), ``filter="png"`` adds the row filter. ``src_size`` defaults
    to the side of the first record's channel image, read from its header.
    """
    if compress not in (None, "zlib", "zstd"):
        raise ValueError(f"unknown pack compression {compress!r}")
    if filter not in (None, "png"):
        raise ValueError(f"unknown pack filter {filter!r}")
    if filter and not compress:
        raise ValueError("filter requires a compress codec")
    if compress:
        load_codec(compress)  # a host without the codec's library fails before any work
    records = all_records(index)
    if src_size is None:
        r0 = records[0]
        probe_path = image_path(img_dir, index.split, r0.experiment, r0.plate, r0.well, 1,
                                channels[0], ext)
        try:
            probe = image_size(probe_path, device)
        except (OSError, ValueError) as e:
            raise FileNotFoundError(
                f"cannot read probe image {probe_path!r} to infer src_size; "
                "pass src_size explicitly or fix the source tree") from e
        if probe[0] != probe[1]:
            raise ValueError(f"pack format assumes square sources, got {probe} "
                             f"from {probe_path!r}")
        src_size = probe[0]
    c, h, w = len(channels), src_size, src_size
    decode_device = "cpu" if ext == "png" else device

    os.makedirs(out_dir, exist_ok=True)
    pack_path = os.path.join(out_dir, f"{index.split}.rxpack")
    entries: Dict[str, int] = {}
    offsets, lengths = [], []
    pos = ordinal = 0
    with open(pack_path, "wb") as f:
        for start in range(0, len(records), batch_wells):
            chunk = records[start:start + batch_wells]
            paths, keys = [], []
            for r in chunk:
                for site in (1, 2):
                    keys.append(_key(r.experiment, r.plate, r.well, site))
                    paths += [image_path(img_dir, index.split, r.experiment, r.plate, r.well,
                                         site, ch, ext) for ch in channels]
            planes = decode_files(paths, h, w, nthreads=decoder_threads, strict=True,
                                  device=decode_device)
            if isinstance(planes, torch.Tensor):
                planes = planes.cpu().numpy()
            planes = planes.reshape(len(keys), c, h, w)
            if compress:
                blobs = deflate_filtered_batch(planes, level=compress_level,
                                               use_filter=filter == "png",
                                               nthreads=decoder_threads, codec=compress)
            else:
                blobs = [view.tobytes() for view in planes]
            for k, blob in zip(keys, blobs):
                entries[k] = ordinal
                if compress:
                    offsets.append(pos)
                    lengths.append(len(blob))
                    pos += len(blob)
                f.write(blob)
                ordinal += 1
            if verbose:
                print(f"Packing {index.split}: {start + len(chunk)}/{len(records)} wells",
                      file=sys.stderr)
    meta = {"h": h, "w": w, "channels": c, "entries": entries}
    if compress:
        meta["compress"] = compress
        meta["offsets"] = offsets
        meta["lengths"] = lengths
        if filter:
            meta["filter"] = filter
    with open(pack_path + ".json", "w") as f:
        json.dump(meta, f)
    return pack_path


class PackStore:
    """Memory-mapped reader over a raw or compressed pack; the Pipeline's
    decoded store. Opening a compressed pack binds its codec's library, so a
    host without it fails here, naming the library."""

    def __init__(self, pack_path: str):
        with open(pack_path + ".json") as f:
            meta = json.load(f)
        self.h, self.w = meta["h"], meta["w"]
        self.n_channels = meta["channels"]
        self.compress = meta.get("compress")
        self.filter = meta.get("filter")
        if self.compress not in (None, "zlib", "zstd"):
            raise ValueError(f"{pack_path}: unknown pack compression {self.compress!r}")
        if self.filter not in (None, "png") or (self.filter and not self.compress):
            raise ValueError(f"{pack_path}: unknown pack filter {self.filter!r} "
                             f"(compression {self.compress!r})")
        if self.compress:
            load_codec(self.compress)
            self._offsets = np.asarray(meta["offsets"], dtype=np.int64)
            self._lengths = np.asarray(meta["lengths"], dtype=np.int64)
        self._entries = meta["entries"]
        self._mm = np.memmap(pack_path, dtype=np.uint8, mode="r")
        self._view_elems = self.n_channels * self.h * self.w

    def _ordinal(self, r: WellRecord, site: int) -> int:
        return self._entries[_key(r.experiment, r.plate, r.well, site)]

    def get_decoded_batch(self, keys: Sequence[Tuple[WellRecord, int]],
                          nthreads: int = 0) -> np.ndarray:
        """uint8 [len(keys), C, H, W] for (record, site) pairs: a memcpy per
        view of a raw pack, one strict inflate of ``nthreads`` threads (0:
        every core) for a compressed one."""
        shape = (len(keys), self.n_channels, self.h, self.w)
        ordinals = [self._ordinal(r, site) for r, site in keys]
        if self.compress:
            offsets, lengths = self._offsets[ordinals], self._lengths[ordinals]
            if self.filter == "png":
                return inflate_unfilter_batch(self._mm, offsets, lengths, *shape[1:],
                                              nthreads=nthreads, strict=True,
                                              codec=self.compress)
            return inflate_batch(self._mm, offsets, lengths, self._view_elems,
                                 nthreads=nthreads, strict=True,
                                 codec=self.compress).reshape(shape)
        out = np.empty((len(keys), self._view_elems), np.uint8)
        for i, o in enumerate(ordinals):
            off = o * self._view_elems
            out[i] = self._mm[off: off + self._view_elems]
        return out.reshape(shape)
