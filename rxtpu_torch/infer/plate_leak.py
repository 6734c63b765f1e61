"""Plate-leak constrained label assignment (counterpart of
``rxtpu/infer/plate_leak.py``), numpy on the host as in rxtpu.

Each sirna appears on one of 4 plate groups per experiment: mask the classes
that cannot sit on a sample's plate, then assign one class per row greedily
(the exact host loop of rxtpu), optimally (Hungarian), or by plain argmax.
"""

from __future__ import annotations

import numpy as np


def rescale(preds: np.ndarray) -> np.ndarray:
    """Row-normalize with a zero-sum guard."""
    s = preds.sum(axis=1)
    s[s == 0] = 1.0
    return preds / s[:, None]


def apply_plate_mask(preds: np.ndarray, plates: np.ndarray,
                     plate_groups: np.ndarray, experiment_type: int) -> np.ndarray:
    """Zero the classes whose plate under this experiment's layout is not the
    sample's plate, then rescale."""
    preds = preds.copy()
    class_plates = plate_groups[:, experiment_type]
    mask = class_plates[None, :] != plates[:, None]
    preds[mask] = 0.0
    return rescale(preds)


def greedy_assign(preds: np.ndarray) -> np.ndarray:
    """Take the globally most confident (row, class), assign it, zero that row
    and column, renormalize; N times. Ties go to the first index."""
    preds = rescale(preds.copy())
    results = np.zeros(preds.shape[0])
    for _ in range(preds.shape[0]):
        best_class_per_sample = np.argmax(preds, axis=1)
        winner = np.argmax(preds[np.arange(len(preds)), best_class_per_sample])
        winner_class = best_class_per_sample[winner]
        results[winner] = winner_class
        preds[:, winner_class] = 0.0
        preds[winner, :] = 0.0
        preds = rescale(preds)
    return results


def hungarian_assign(preds: np.ndarray) -> np.ndarray:
    """Optimal one-to-one assignment maximizing the total log-probability."""
    from scipy.optimize import linear_sum_assignment

    cost = -np.log(np.clip(preds, 1e-30, None))
    rows, cols = linear_sum_assignment(cost)
    results = np.zeros(preds.shape[0])
    results[rows] = cols
    return results


def constrained_predict(probs: np.ndarray, plates: np.ndarray,
                        plate_groups: np.ndarray, experiment_type: int,
                        method: str = "greedy") -> np.ndarray:
    """Mask, then assign, for one experiment."""
    masked = apply_plate_mask(probs, plates, plate_groups, experiment_type)
    if method == "greedy":
        return greedy_assign(masked)
    if method == "hungarian":
        return hungarian_assign(masked)
    if method == "argmax":
        return masked.argmax(axis=1).astype(np.float64)
    if method == "greedy_jax":
        raise NotImplementedError("assignment method 'greedy_jax' is not ported yet")
    raise ValueError(f"unknown assignment method {method!r}")
