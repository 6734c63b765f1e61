"""Synthetic test-phase fixture, numpy only (the plate-balanced layout of
``rxtpu/data/synthetic.py``), and seeded random model weights.

``make_test_fixture`` writes what the test phase reads, with no image
files: metadata CSVs, a stats JSON and a raw pack of the test views.

- ``train.csv`` (metadata only): every sirna sits on 3 of the 4 plates,
  once per train experiment, so ``build_plate_groups`` succeeds. Sirna k
  never sits on plate ``k % 4 + 1``; wells spread evenly over the plates
  (at most 306 sample wells per plate, as on a 308-well Kaggle plate).
- one test experiment of 4 plates: ``n_test_wells`` distinct sirnas, sirna
  k on ``plate_groups[k, test_type]``, plus each plate's B02 negative
  control and ``pos_controls_per_plate`` positive controls.
- ``packs/test.rxpack``: both sites of every test and control well, random
  uint8 [6, img_size, img_size] views.
- ``stats_experiments.json``: the test experiment's per-channel mean/std of
  those views.

``randomize_`` gives a model random weights from a seeded
``torch.Generator``, BN affines and running stats included.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from rxtpu_torch.config import NB_CHANNELS
from rxtpu_torch.data.pack import write_raw_pack
from rxtpu_torch.data.records import NEG_CONTROL_WELL, build_plate_groups
from rxtpu_torch.data.stats import save_stats
from rxtpu_torch.models.resnet import BatchNorm, BottleneckBlock, ResNetBlock

_ROWS = "BCDEFGHIJKLMNO"  # 14 x 22 = 308 wells, B02..O23


def well_name(i: int) -> str:
    """Well i of a 308-well plate; well 0 is B02, the negative control."""
    return f"{_ROWS[i // 22]}{2 + i % 22:02d}"


def _write_csv(path: str, rows: List[Dict], columns: Sequence[str]) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=columns, lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)


def make_test_fixture(root: str, nb_classes: int = 1108, n_test_wells: int = 32,
                      test_type: int = 0, img_size: int = 512,
                      n_train_experiments: int = 3, pos_controls_per_plate: int = 2,
                      seed: int = 0) -> Dict:
    """Write the fixture under ``root``; returns paths and ground truth."""
    if n_test_wells > nb_classes:
        raise ValueError("more test wells than sirnas")
    rng = np.random.default_rng(seed)
    meta = os.path.join(root, "data", "metadata")
    os.makedirs(meta, exist_ok=True)
    first_sample_well = 1 + pos_controls_per_plate

    train_rows = []
    for e in range(n_train_experiments):
        exp = f"HUVEC-{e + 1:02d}"
        used = {p: 0 for p in (1, 2, 3, 4)}
        for k in range(nb_classes):
            allowed = [p for p in (1, 2, 3, 4) if p != k % 4 + 1]
            plate = allowed[(e + k // 4) % 3]
            well = well_name(first_sample_well + used[plate])
            used[plate] += 1
            train_rows.append(dict(id_code=f"{exp}_{plate}_{well}", experiment=exp,
                                   plate=plate, well=well, sirna=k))
    _write_csv(os.path.join(meta, "train.csv"), train_rows,
               ["id_code", "experiment", "plate", "well", "sirna"])
    plate_groups = build_plate_groups(train_rows, nb_classes)

    exp = "U2OS-01"
    sirnas = np.sort(rng.choice(nb_classes, n_test_wells, replace=False))
    test_rows, truth = [], []
    used = {p: 0 for p in (1, 2, 3, 4)}
    for k in sirnas.tolist():
        plate = int(plate_groups[k, test_type])
        well = well_name(first_sample_well + used[plate])
        used[plate] += 1
        test_rows.append(dict(id_code=f"{exp}_{plate}_{well}", experiment=exp,
                              plate=plate, well=well))
        truth.append(k)
    control_rows = []
    for plate in (1, 2, 3, 4):
        control_rows.append(dict(id_code=f"{exp}_{plate}_{NEG_CONTROL_WELL}", experiment=exp,
                                 plate=plate, well=NEG_CONTROL_WELL, sirna=1138,
                                 well_type="negative_control"))
        for p in range(pos_controls_per_plate):
            well = well_name(1 + p)
            control_rows.append(dict(id_code=f"{exp}_{plate}_{well}", experiment=exp,
                                     plate=plate, well=well, sirna=1108 + p,
                                     well_type="positive_control"))
    _write_csv(os.path.join(meta, "test.csv"), test_rows,
               ["id_code", "experiment", "plate", "well"])
    _write_csv(os.path.join(meta, "test_controls.csv"), control_rows,
               ["id_code", "experiment", "plate", "well", "sirna", "well_type"])

    sums = np.zeros((NB_CHANNELS, 2))  # sum(x/255), sum((x/255)^2) per channel
    n_views = 0

    def views():
        nonlocal n_views
        for row in test_rows + control_rows:
            for site in (1, 2):
                view = rng.integers(0, 256, (NB_CHANNELS, img_size, img_size), dtype=np.uint8)
                x = view.reshape(NB_CHANNELS, -1).astype(np.float64) / 255.0
                sums[:, 0] += x.sum(axis=1)
                sums[:, 1] += (x * x).sum(axis=1)
                n_views += 1
                yield (row["experiment"], row["plate"], row["well"], site), view

    pack = write_raw_pack(os.path.join(root, "packs"), "test", views())
    count = n_views * img_size * img_size
    mean = sums[:, 0] / count
    stats_path = os.path.join(root, "stats_experiments.json")
    save_stats({exp: {"mean": mean, "std": np.sqrt(sums[:, 1] / count - mean**2)}},
               stats_path)
    return {
        "data_dir": os.path.join(root, "data"),
        "pack_dir": os.path.join(root, "packs"),
        "pack": pack,
        "stats": stats_path,
        "test_rows": test_rows,
        "truth": truth,
        "plate_groups": plate_groups,
    }


@torch.no_grad()
def randomize_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Random weights from a seeded generator, in place.

    Convs: He normal over fan-out; Linear: uniform +-1/sqrt(fan_in); BN:
    weight U(0.5, 1.5), bias N(0, 0.1), running mean N(0, 0.1), running
    var U(0.5, 1.5). The last BN of each residual branch is scaled by 0.2 so
    activations stay in range through a deep net (rxtpu zero-inits that
    scale, which would leave every branch dead after folding).
    """
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            fan_out = mod.out_channels * mod.kernel_size[0] * mod.kernel_size[1]
            mod.weight.normal_(0.0, (2.0 / fan_out) ** 0.5, generator=gen)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Linear):
            bound = mod.in_features ** -0.5
            mod.weight.uniform_(-bound, bound, generator=gen)
            mod.bias.uniform_(-bound, bound, generator=gen)
        elif isinstance(mod, BatchNorm):
            mod.weight.uniform_(0.5, 1.5, generator=gen)
            mod.bias.normal_(0.0, 0.1, generator=gen)
            mod.running_mean.normal_(0.0, 0.1, generator=gen)
            mod.running_var.uniform_(0.5, 1.5, generator=gen)
    for mod in model.modules():
        if isinstance(mod, BottleneckBlock):
            mod.BatchNorm_2.weight.mul_(0.2)
        elif isinstance(mod, ResNetBlock):
            mod.BatchNorm_1.weight.mul_(0.2)
    return model
