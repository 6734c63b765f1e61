"""Submission writer (counterpart of ``rxtpu/infer/submit.py``), with ``csv``.

Columns ``id_code,sirna`` (int sirna), no index, ``\\n`` line ends: the
same bytes as rxtpu's pandas ``to_csv``.
"""

from __future__ import annotations

import csv
import os
from typing import Sequence

import numpy as np


def write_submission(id_codes: Sequence[str], preds: np.ndarray,
                     experiment_id: str, out_dir: str = ".") -> str:
    path = os.path.join(out_dir, f"submission_{experiment_id}.csv")
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(["id_code", "sirna"])
        writer.writerows(zip(id_codes, np.asarray(preds).astype(int).tolist()))
    return path
