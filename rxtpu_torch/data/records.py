"""Metadata index: experiments / plates / wells + controls (counterpart of
``rxtpu/data/records.py``), over rows read with the ``csv`` module.

A metadata table is a list of dicts, one per CSV row, in file order; the
``plate`` and ``sirna`` columns are ints, everything else a string.

The train/val splits reproduce rxtpu's row for row without sklearn or
pandas: ``stratified_split`` is sklearn's ``train_test_split`` (a
``StratifiedShuffleSplit`` by sirna, or a ``ShuffleSplit``) on a
``RandomState(seed)``, and ``split_by_experiment`` holds out a third of each
celltype's experiments, then shuffles each part as ``DataFrame.sample(frac=1,
random_state=seed)`` does.
"""

from __future__ import annotations

import csv
import dataclasses
import math
import os
import random
from typing import Dict, List, Sequence, Tuple

import numpy as np

NEG_CONTROL_WELL = "B02"
_INT_COLUMNS = ("plate", "sirna")

Row = Dict[str, object]


def get_celltype(experiment: str) -> str:
    """Celltype prefix of the experiment name."""
    return experiment.split("-")[0]


def image_path(img_dir: str, split: str, experiment: str, plate: int, well: str,
               site: int, channel: int, ext: str = "jpeg") -> str:
    """``{img_dir}/{split}/{experiment}/Plate{plate}/{well}_s{site}_w{channel}.{ext}``."""
    return "/".join([img_dir, split, experiment, f"Plate{plate}",
                     f"{well}_s{site}_w{channel}.{ext}"])


@dataclasses.dataclass(frozen=True)
class WellRecord:
    """One well = one classification sample (2 sites x 6 channels)."""

    id_code: str
    experiment: str
    plate: int
    well: str
    sirna: int  # -1 for unlabeled test wells
    celltype: str


@dataclasses.dataclass
class MetadataIndex:
    """One split's wells plus its control wells, keyed by (experiment, plate)."""

    records: List[WellRecord]
    neg_controls: Dict[Tuple[str, int], WellRecord]
    pos_controls: Dict[Tuple[str, int], List[WellRecord]]
    split: str

    def __len__(self) -> int:
        return len(self.records)

    def control_views(self, experiment: str, plate: int, rng: random.Random):
        """(neg, pos) control wells for a sample: B02, and a uniformly random
        positive-control well of the same (experiment, plate)."""
        key = (experiment, plate)
        neg = self.neg_controls[key]
        pos_wells = self.pos_controls[key]
        pos = pos_wells[rng.randrange(len(pos_wells))]
        return neg, pos

    def for_experiment(self, experiment: str) -> "MetadataIndex":
        return MetadataIndex(
            records=[r for r in self.records if r.experiment == experiment],
            neg_controls={k: v for k, v in self.neg_controls.items() if k[0] == experiment},
            pos_controls={k: v for k, v in self.pos_controls.items() if k[0] == experiment},
            split=self.split,
        )


def all_records(index: MetadataIndex) -> List[WellRecord]:
    """Every distinct well of an index: samples, then negative and positive
    controls, first appearance kept (controls repeat across plates' lists)."""
    records = list(index.records) + list(index.neg_controls.values())
    for wells in index.pos_controls.values():
        records += wells
    seen, out = set(), []
    for r in records:
        key = (r.experiment, r.plate, r.well)
        if key not in seen:
            seen.add(key)
            out.append(r)
    return out


def read_csv(path: str) -> List[Row]:
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    for row in rows:
        for col in _INT_COLUMNS:
            if col in row:
                row[col] = int(row[col])
    return rows


def read_metadata_csvs(path_metadata: str, split: str) -> Tuple[List[Row], List[Row]]:
    """({split}.csv, {split}_controls.csv) rows."""
    return (read_csv(os.path.join(path_metadata, f"{split}.csv")),
            read_csv(os.path.join(path_metadata, f"{split}_controls.csv")))


def _record(row: Row) -> WellRecord:
    experiment = str(row["experiment"])
    return WellRecord(
        id_code=str(row["id_code"]), experiment=experiment, plate=int(row["plate"]),
        well=str(row["well"]), sirna=int(row.get("sirna", -1)),
        celltype=get_celltype(experiment),
    )


def load_metadata(rows: Sequence[Row], control_rows: Sequence[Row],
                  split: str) -> MetadataIndex:
    """Index from metadata rows. Negative controls are the B02 wells; positive
    controls keep every positive-control well."""
    neg_controls: Dict[Tuple[str, int], WellRecord] = {}
    pos_controls: Dict[Tuple[str, int], List[WellRecord]] = {}
    for row in control_rows:
        if row["well_type"] == "negative_control" and row["well"] == NEG_CONTROL_WELL:
            r = _record(row)
            neg_controls[(r.experiment, r.plate)] = r
    for row in control_rows:
        if row["well_type"] == "positive_control":
            r = _record(row)
            pos_controls.setdefault((r.experiment, r.plate), []).append(r)
    return MetadataIndex([_record(row) for row in rows], neg_controls, pos_controls, split)


def build_plate_groups(train_rows: Sequence[Row], nb_classes: int = 1108) -> np.ndarray:
    """For each sirna, the 4 plates it can appear on: int [nb_classes, 4].

    Each sirna sits on exactly 3 of the 4 plates in train; columns 0-2 are
    those plates by descending row count, ties in order of first appearance
    (pandas ``value_counts`` order), and the missing 4th is ``10 - sum``.
    Raises ValueError when a sirna is not on exactly 3 plates.
    """
    counts: Dict[int, Dict[int, int]] = {}
    for row in train_rows:
        per_plate = counts.setdefault(int(row["sirna"]), {})
        per_plate[int(row["plate"])] = per_plate.get(int(row["plate"]), 0) + 1
    plate_groups = np.zeros((nb_classes, 4), dtype=np.int64)
    for sirna in range(nb_classes):
        per_plate = counts.get(sirna, {})
        grp = sorted(per_plate, key=lambda p: -per_plate[p])  # stable: ties keep order
        if len(grp) != 3:
            raise ValueError(f"sirna {sirna}: expected 3 plates, got {len(grp)}")
        plate_groups[sirna, 0:3] = grp
        plate_groups[sirna, 3] = 10 - sum(grp)
    return plate_groups


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """sklearn's approximate mode of the multivariate hypergeometric: the
    floored shares, topped up by largest remainder, ties broken by ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _stratified_indices(labels: Sequence[str], n_train: int, n_test: int,
                        rng: np.random.RandomState) -> Tuple[np.ndarray, np.ndarray]:
    classes, y_indices, class_counts = np.unique(
        np.asarray(labels), return_inverse=True, return_counts=True)
    if class_counts.min() < 2:
        raise ValueError("The least populated classes in y have only 1 member, which "
                         f"is too few: {classes[class_counts < 2].tolist()}")
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(f"train ({n_train}) and test ({n_test}) sizes must each be at "
                         f"least the number of classes ({len(classes)})")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train: List[int] = []
    test: List[int] = []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[:n_i[i]])
        test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def stratified_split(rows: Sequence[Row], val_fraction: float = 0.1, seed: int = 42,
                     stratify_by_sirna: bool = True) -> Tuple[List[Row], List[Row]]:
    """(train, val) rows as sklearn's ``train_test_split(df,
    test_size=val_fraction, random_state=seed, stratify=df[["sirna"]])``."""
    n = len(rows)
    if not 0 < val_fraction < 1:
        raise ValueError(f"val_fraction {val_fraction} must be in (0, 1)")
    n_test = math.ceil(val_fraction * n)
    n_train = n - n_test
    if n_train == 0:
        raise ValueError(f"{n} rows leave no training rows at val_fraction {val_fraction}")
    rng = np.random.RandomState(seed)
    if stratify_by_sirna:
        # sklearn maps each row of the 2-D stratify frame to its string form
        train, test = _stratified_indices([str(int(r["sirna"])) for r in rows],
                                          n_train, n_test, rng)
    else:
        perm = rng.permutation(n)
        test, train = perm[:n_test], perm[n_test:n_test + n_train]
    return [rows[i] for i in train], [rows[i] for i in test]


def _shuffled(rows: List[Row], seed: int) -> List[Row]:
    """``DataFrame.sample(frac=1, random_state=seed)``'s row order."""
    order = np.random.RandomState(seed).choice(len(rows), size=len(rows), replace=False)
    return [rows[i] for i in order]


def split_by_experiment(rows: Sequence[Row], random_state: int) -> Tuple[List[Row], List[Row]]:
    """Experiment-wise holdout: per celltype (in order of first appearance),
    shuffle its experiments with ``random.Random(random_state)`` and hold
    out the first floor(n/3) as validation; then shuffle both parts."""
    rng = random.Random(random_state)
    celltypes = list(dict.fromkeys(get_celltype(str(r["experiment"])) for r in rows))
    train_rows: List[Row] = []
    val_rows: List[Row] = []
    for celltype in celltypes:
        ct_rows = [r for r in rows if get_celltype(str(r["experiment"])) == celltype]
        exps = list(dict.fromkeys(r["experiment"] for r in ct_rows))
        rng.shuffle(exps)
        exps_val = set(exps[: len(exps) // 3])
        train_rows += [r for r in ct_rows if r["experiment"] not in exps_val]
        val_rows += [r for r in ct_rows if r["experiment"] in exps_val]
    return _shuffled(train_rows, random_state), _shuffled(val_rows, random_state)
