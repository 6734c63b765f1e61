"""The reference's own assembly of the batches the program is fed.

rxtpu's batch semantics (``rxtpu/data/pipeline.py``), worked out here from
the benchmark's rows and pack, independently of the program's pipeline:

- train: epoch ``e`` visits the samples in ``default_rng((seed*1000003 +
  e) & 0x7FFFFFFF).permutation(n)`` order; each row draws, from
  ``default_rng(SeedSequence((seed, 0x5EED, e, position)))``, its positive
  control well of the plate, then a site for each of its G=3 views
  ``[sample, negative control (B02), positive control]``;
- test: samples in order, G=6 views ``[sample s1, s2, negative s1, s2,
  positive s1, s2]``, the positive control drawn as in train.

Per-sample mean and std are the sample's experiment's.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def train_order(n: int, seed: int, epoch: int) -> np.ndarray:
    return np.random.default_rng((seed * 1000003 + epoch) & 0x7FFFFFFF).permutation(n)


def _view_keys(ds, row: dict, seed: int, epoch: int, position: int, g: int):
    rng = np.random.default_rng(np.random.SeedSequence((seed, 0x5EED, epoch, position)))
    plate = (row["experiment"], row["plate"])
    neg = ds.neg_well[plate]
    wells = ds.pos_wells[plate]
    pos = wells[int(rng.integers(0, len(wells)))]
    if g == 3:
        return [(row["well"], int(rng.integers(1, 3))), (neg, int(rng.integers(1, 3))),
                (pos, int(rng.integers(1, 3)))]
    return [(row["well"], 1), (row["well"], 2), (neg, 1), (neg, 2), (pos, 1), (pos, 2)]


def assemble(ds, rows: List[dict], seed: int, epoch: int, first_position: int, g: int,
             device) -> Dict[str, torch.Tensor]:
    """uint8 images [B, G, 6, S, S], labels, mean and std [B, 6] on ``device``."""
    views = []
    for k, row in enumerate(rows):
        for well, site in _view_keys(ds, row, seed, epoch, first_position + k, g):
            views.append(ds.view(row["experiment"], row["plate"], well, site))
    images = torch.from_numpy(np.stack(views)).to(device)
    images = images.reshape((len(rows), g) + tuple(images.shape[1:]))
    mean = np.stack([ds.stats[r["experiment"]]["mean"] for r in rows]).astype(np.float32)
    std = np.stack([ds.stats[r["experiment"]]["std"] for r in rows]).astype(np.float32)
    return {"images": images,
            "labels": torch.tensor([r["sirna"] for r in rows], device=device),
            "mean": torch.from_numpy(mean).to(device), "std": torch.from_numpy(std).to(device)}


def train_batch(ds, seed: int, epoch: int, index: int, batch: int, device):
    order = train_order(len(ds.rows), seed, epoch)
    rows = [ds.rows[j] for j in order[index * batch:(index + 1) * batch]]
    return assemble(ds, rows, seed, epoch, index * batch, 3, device)


def test_rows(ds, positions: List[int], seed: int, device) -> Tuple[Dict, List[str]]:
    """The test batch of the samples at ``positions`` (epoch 0), and their ids."""
    out = None
    rows = [ds.rows[p] for p in positions]
    views, ids = [], []
    for p, row in zip(positions, rows):
        one = assemble(ds, [row], seed, 0, p, 6, device)
        views.append(one)
        ids.append(row["id_code"])
    out = {k: torch.cat([v[k] for v in views]) for k in views[0]}
    return out, ids
