"""Plate-leak constrained label assignment (counterpart of
``rxtpu/infer/plate_leak.py``), numpy on the host as in rxtpu.

Each sirna appears on one of 4 plate groups per experiment: mask the classes
that cannot sit on a sample's plate, then assign one class per row greedily
(the exact host loop of rxtpu), greedily on the run's device in f32
(``greedy_jax``: ``greedy_assign_jax``, rxtpu's ``fori_loop`` of the same
name in torch ops), optimally (Hungarian), or by plain argmax.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch


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


def greedy_assign_loop(p: torch.Tensor) -> torch.Tensor:
    """``greedy_assign_jax``'s loop on ``p``'s device: f32 results [N], no host
    sync inside (indices stay 0-dim tensors and index through ``gather`` and
    ``index_fill_``). Each of the N iterations renormalizes the rows first
    (zero-sum guard), takes each row's argmax, then the argmax over the row
    maxima (first index on ties, as ``torch.argmax``), and zeroes that
    column and that row."""
    p = p.to(torch.float32).clone()
    n = p.shape[0]
    results = torch.zeros(n, dtype=torch.float32, device=p.device)
    for _ in range(n):
        s = p.sum(dim=1)
        p = p / torch.where(s == 0, 1.0, s)[:, None]
        row_best = p.argmax(dim=1)
        row_vals = p.gather(1, row_best[:, None])[:, 0]
        r = row_vals.argmax().view(1)
        col = row_best.gather(0, r)
        results.scatter_(0, r, col.to(torch.float32))
        p.index_fill_(1, col, 0.0)
        p.index_fill_(0, r, 0.0)
    return results


def greedy_assign_jax(preds: np.ndarray, device: Union[str, torch.device] = "cpu"
                      ) -> np.ndarray:
    """rxtpu's ``greedy_assign_jax`` (``--assign-method greedy_jax``): the
    probabilities go to f32 on ``device`` and through ``greedy_assign_loop``;
    the assignment comes back as f32, as rxtpu's does."""
    p = torch.as_tensor(np.asarray(preds)).to(device=device, dtype=torch.float32)
    return greedy_assign_loop(p).cpu().numpy()


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
                        method: str = "greedy",
                        device: Union[str, torch.device] = "cpu") -> np.ndarray:
    """Mask, then assign, for one experiment; ``greedy_jax`` runs on ``device``."""
    masked = apply_plate_mask(probs, plates, plate_groups, experiment_type)
    if method == "greedy":
        return greedy_assign(masked)
    if method == "greedy_jax":
        return greedy_assign_jax(masked, device)
    if method == "hungarian":
        return hungarian_assign(masked)
    if method == "argmax":
        return masked.argmax(axis=1).astype(np.float64)
    raise ValueError(f"unknown assignment method {method!r}")
