"""Dataset exploration report (counterpart of ``rxtpu/analysis.py``, the
reference notebook's facts), on the rows of ``csv`` files in place of
pandas frames.

The facts the pipeline relies on: id codes ``{celltype}-{batch}_{plate}_{well}``,
the celltypes' wells, experiments, plates and siRNAs, one negative control
per plate at well B02, positive controls on every plate, and each siRNA on
three plates. Each function takes rows as ``rxtpu_torch.data.records.read_csv``
gives them (dicts; ``plate`` and ``sirna`` as ints) and returns plain dicts.

    python -m rxtpu_torch.analysis --metadata data/metadata
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from rxtpu_torch.data.records import NEG_CONTROL_WELL, Row, get_celltype, read_csv


def parse_id_code(id_code: str) -> Dict[str, object]:
    """``HUVEC-01_3_B05`` -> experiment, celltype, plate and well."""
    experiment, plate, well = id_code.split("_")
    return {"experiment": experiment, "celltype": get_celltype(experiment),
            "plate": int(plate), "well": well}


def celltype_summary(rows: Sequence[Row]) -> Dict[str, Dict[str, int]]:
    """Per celltype (sorted): ``wells``, distinct ``experiments``, physical
    ``plates`` (distinct (experiment, plate) pairs: plate ids repeat 1..4 in
    every experiment) and, where the rows have a ``sirna`` column, distinct
    ``sirnas``."""
    with_sirna = bool(rows) and "sirna" in rows[0]
    groups: Dict[str, List[Row]] = {}
    for r in rows:
        groups.setdefault(get_celltype(r["experiment"]), []).append(r)
    out = {}
    for celltype in sorted(groups):
        g = groups[celltype]
        out[celltype] = {"wells": len(g),
                         "experiments": len({r["experiment"] for r in g}),
                         "plates": len({(r["experiment"], r["plate"]) for r in g})}
        if with_sirna:
            out[celltype]["sirnas"] = len({r["sirna"] for r in g})
    return out


def control_summary(control_rows: Sequence[Row]) -> Dict[Tuple[str, int], Dict[str, int]]:
    """Per (experiment, plate), sorted: the distinct wells of each well type
    (every type seen in the table, 0 where a plate has none)."""
    types = sorted({r["well_type"] for r in control_rows})
    wells: Dict[Tuple[str, int], Dict[str, set]] = {}
    for r in control_rows:
        per_type = wells.setdefault((r["experiment"], r["plate"]), {t: set() for t in types})
        per_type[r["well_type"]].add(r["well"])
    return {key: {t: len(ws) for t, ws in wells[key].items()} for key in sorted(wells)}


def check_control_invariants(control_rows: Sequence[Row]) -> Dict[str, bool]:
    """The notebook's key facts, checked against every (experiment, plate) of
    the controls table, so a plate that lacks a control type entirely fails
    (``rxtpu/analysis.py:53-79``)."""
    all_plates = {(r["experiment"], r["plate"]) for r in control_rows}

    def wells_of(well_type: str) -> Dict[Tuple[str, int], List[str]]:
        per_plate: Dict[Tuple[str, int], List[str]] = {}
        for r in control_rows:
            if r["well_type"] == well_type:
                per_plate.setdefault((r["experiment"], r["plate"]), []).append(r["well"])
        return per_plate

    neg = wells_of("negative_control")
    one_neg = set(neg) == all_plates and all(len(ws) >= 1 for ws in neg.values())
    neg_at_b02 = one_neg and all(NEG_CONTROL_WELL in ws for ws in neg.values())
    pos = wells_of("positive_control")
    has_pos = set(pos) == all_plates and all(len(set(ws)) >= 1 for ws in pos.values())
    return {"every_plate_has_negative_control": one_neg,
            "negative_control_at_B02": neg_at_b02,
            "every_plate_has_positive_controls": has_pos}


def describe(values: Sequence[float]) -> Dict[str, float]:
    """pandas' ``describe`` of a number column: count, mean, std (ddof 1;
    NaN for fewer than two values), min, the 25/50/75% quantiles
    (linear interpolation) and max."""
    v = np.asarray(values, dtype=np.float64)
    q25, q50, q75 = np.quantile(v, [0.25, 0.5, 0.75])
    return {"count": float(v.size), "mean": float(v.mean()),
            "std": float(v.std(ddof=1)) if v.size > 1 else math.nan,
            "min": float(v.min()), "25%": float(q25), "50%": float(q50),
            "75%": float(q75), "max": float(v.max())}


def sirna_plate_structure(train_rows: Sequence[Row]) -> Dict[str, float]:
    """``describe`` of the number of distinct plates each siRNA is on (3 in
    the competition's layout)."""
    plates: Dict[int, set] = {}
    for r in train_rows:
        plates.setdefault(r["sirna"], set()).add(r["plate"])
    return describe([len(p) for _, p in sorted(plates.items())])


def _table(header: Sequence[str], rows: Sequence[Sequence[object]]) -> str:
    cells = [[str(c) for c in header]] + [[str(c) for c in row] for row in rows]
    widths = [max(len(row[i]) for row in cells) for i in range(len(header))]
    return "\n".join("  ".join(c.rjust(w) for c, w in zip(row, widths)) for row in cells)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="rxtpu_torch.analysis")
    ap.add_argument("--metadata", default="data/metadata")
    args = ap.parse_args(argv)
    for split in ("train", "test"):
        path = os.path.join(args.metadata, f"{split}.csv")
        if not os.path.exists(path):
            continue
        rows = read_csv(path)
        print(f"== {split} ({len(rows)} wells) ==")
        summary = celltype_summary(rows)
        cols = list(next(iter(summary.values()))) if summary else []
        print(_table(["celltype"] + cols, [[ct] + list(v.values()) for ct, v in summary.items()]),
              "\n")
        cpath = os.path.join(args.metadata, f"{split}_controls.csv")
        if os.path.exists(cpath):
            for k, v in check_control_invariants(read_csv(cpath)).items():
                print(f"  {k}: {v}")
            print()
        if split == "train" and rows and "sirna" in rows[0]:
            print("sirna plate coverage:")
            print(_table(["", "plates"], list(sirna_plate_structure(rows).items())), "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
