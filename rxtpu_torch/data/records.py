"""Metadata index: experiments / plates / wells + controls (counterpart of
``rxtpu/data/records.py``), over rows read with the ``csv`` module.

A metadata table is a list of dicts, one per CSV row, in file order; the
``plate`` and ``sirna`` columns are ints, everything else a string.
"""

from __future__ import annotations

import csv
import dataclasses
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
