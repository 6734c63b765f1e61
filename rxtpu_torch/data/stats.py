"""Per-experiment channel statistics artifact (counterpart of ``load_stats``
and ``stats_table`` in ``rxtpu/data/stats.py``).
"""

from __future__ import annotations

import json
import pickle
from typing import Dict, Sequence, Tuple

import numpy as np

Stats = Dict[str, Dict[str, np.ndarray]]


def load_stats(path: str) -> Stats:
    """Stats from JSON or from the reference ``stats_experiments.pickle``."""
    if path.endswith(".pickle") or path.endswith(".pkl"):
        with open(path, "rb") as f:
            raw = pickle.load(f)
    else:
        with open(path) as f:
            raw = json.load(f)
    return {
        exp: {"mean": np.asarray(v["mean"], dtype=np.float64),
              "std": np.asarray(v["std"], dtype=np.float64)}
        for exp, v in raw.items()
    }


def save_stats(stats: Stats, path: str) -> None:
    payload = {exp: {"mean": np.asarray(v["mean"]).tolist(),
                     "std": np.asarray(v["std"]).tolist()}
               for exp, v in stats.items()}
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)


def stats_table(stats: Stats, experiments: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Dense f32 [n_exp, 6] mean/std tables."""
    mean = np.stack([np.asarray(stats[e]["mean"], dtype=np.float32) for e in experiments])
    std = np.stack([np.asarray(stats[e]["std"], dtype=np.float32) for e in experiments])
    return mean, std
