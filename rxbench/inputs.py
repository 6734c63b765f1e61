"""The one generator of the benchmark's inputs, driven by a traffic file.

A split laid out as RxRx1 lays out its plates: per experiment 4 plates of
308 interior wells (rows B-O, columns 02-23), each plate one negative
control (B02), 30 positive controls and 277 samples, so that an
experiment holds each of 1108 siRNAs once. Experiments cycle through the
four cell types. Images are 6 x S x S uint8 sites; ``unique_views``
distinct sites are made on the device from the seed (smooth blobs under
noise, as microscopy planes are smooth, each site and channel with its own
gain and offset) and written once as a raw pack,
and every (well, site) key points at one of them, drawn from the seed:
the disk holds little, the batches are the size a deployment's are.
Per-experiment channel statistics are computed from the pack in float64.

Traffic keys read here: ``mode`` (train: labelled samples; predict:
unlabelled), ``input`` (``raw_pack``), ``experiments``, ``src``,
``unique_views``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

CELL_TYPES = ("HEPG2", "HUVEC", "RPE", "U2OS")
SIRNAS = 1108
PLATES = 4
POS_CONTROLS = 30
CHANNELS = 6
ROWS, COLS = "BCDEFGHIJKLMNO", range(2, 24)
NEG_WELL = "B02"


class Dataset:
    """Rows and control rows as the metadata CSVs hold them, the pack's path
    and entries, the statistics; ``view`` reads one site from the pack."""

    def __init__(self, rows, control_rows, pack_path, entries, stats, size):
        self.rows, self.control_rows = rows, control_rows
        self.pack_path, self.entries, self.stats, self.size = pack_path, entries, stats, size
        self.neg_well = {(r["experiment"], r["plate"]): r["well"] for r in control_rows
                         if r["well_type"] == "negative_control"}
        self.pos_wells: Dict[Tuple[str, int], List[str]] = {}
        for r in control_rows:
            if r["well_type"] == "positive_control":
                self.pos_wells.setdefault((r["experiment"], r["plate"]), []).append(r["well"])
        self._mm = np.memmap(pack_path, dtype=np.uint8, mode="r")

    def view(self, experiment: str, plate: int, well: str, site: int) -> np.ndarray:
        n = CHANNELS * self.size * self.size
        o = self.entries[f"{experiment}|{plate}|{well}|{site}"] * n
        return np.asarray(self._mm[o:o + n]).reshape(CHANNELS, self.size, self.size)


def _layout(rng: np.random.Generator, n_experiments: int, labelled: bool):
    wells = [f"{r}{c:02d}" for r in ROWS for c in COLS]
    rows, controls = [], []
    for e in range(n_experiments):
        exp = f"{CELL_TYPES[e % len(CELL_TYPES)]}-{e // len(CELL_TYPES) + 1:02d}"
        sirnas = rng.permutation(SIRNAS)
        per_plate = SIRNAS // PLATES
        for p in range(PLATES):
            plate = p + 1
            others = [w for w in wells if w != NEG_WELL]
            pick = rng.permutation(len(others))
            pos = [others[i] for i in sorted(pick[:POS_CONTROLS])]
            samples = [others[i] for i in sorted(pick[POS_CONTROLS:])]
            controls.append({"id_code": f"{exp}_{plate}_{NEG_WELL}", "experiment": exp,
                             "plate": plate, "well": NEG_WELL, "sirna": SIRNAS + POS_CONTROLS,
                             "well_type": "negative_control"})
            for j, w in enumerate(pos):
                controls.append({"id_code": f"{exp}_{plate}_{w}", "experiment": exp,
                                 "plate": plate, "well": w, "sirna": SIRNAS + j,
                                 "well_type": "positive_control"})
            for w, s in zip(samples, sirnas[p * per_plate:(p + 1) * per_plate]):
                rows.append({"id_code": f"{exp}_{plate}_{w}", "experiment": exp,
                             "plate": plate, "well": w,
                             "sirna": int(s) if labelled else -1})
    return rows, controls


@torch.no_grad()
def _make_views(n: int, size: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    low = torch.rand((n, CHANNELS, 16, 16), generator=gen, device=device)
    smooth = F.interpolate(low, size=(size, size), mode="bilinear", align_corners=False)
    noise = torch.rand((n, CHANNELS, size, size), generator=gen, device=device)
    # per site and channel a gain and an offset, as stains and cell counts
    # differ from well to well: pooled features then differ between wells
    gain = torch.rand((n, CHANNELS, 1, 1), generator=gen, device=device) * 0.75 + 0.25
    offset = torch.rand((n, CHANNELS, 1, 1), generator=gen, device=device) * 64.0
    return (offset + gain * (smooth * 190.0 + noise * 60.0)).clamp(0, 255).to(torch.uint8)


def make_dataset(traffic: dict, seed: int, workdir: str, device) -> Dataset:
    """Write the split's pack into ``workdir`` and return its ``Dataset``."""
    if traffic["input"] != "raw_pack":
        raise ValueError(f"the generator writes raw packs only, not {traffic['input']!r}")
    rng = np.random.default_rng(np.random.SeedSequence((seed, 0xDA7A)))
    size, unique = traffic["src"], traffic["unique_views"]
    rows, controls = _layout(rng, traffic["experiments"], traffic["mode"] == "train")
    keys = [f"{r['experiment']}|{r['plate']}|{r['well']}|{s}"
            for r in rows + controls for s in (1, 2)]
    ordinals = rng.integers(0, unique, len(keys))
    entries = dict(zip(keys, (int(o) for o in ordinals)))
    views = _make_views(unique, size, seed, device)
    path = os.path.join(workdir, "split.rxpack")
    views.cpu().numpy().tofile(path)
    with open(path + ".json", "w") as f:
        json.dump({"h": size, "w": size, "channels": CHANNELS, "entries": entries}, f)
    # per-(view, channel) sums of x and x^2, exact in float64, then per experiment
    v = views.reshape(unique, CHANNELS, -1).double()
    sums = torch.stack([v.sum(-1), v.square().sum(-1)], -1).cpu().numpy()  # [U, C, 2]
    stats = {}
    for exp in sorted({r["experiment"] for r in rows}):
        mask = np.array([k.startswith(exp + "|") for k in keys])
        acc = sums[ordinals[mask]].sum(0)  # [C, 2]
        n = mask.sum() * size * size
        mean = acc[:, 0] / n / 255.0
        std = np.sqrt(np.maximum(acc[:, 1] / n / 255.0 ** 2 - mean ** 2, 0.0))
        stats[exp] = {"mean": mean, "std": std}
    return Dataset(rows, controls, path, entries, stats, size)
