"""Per-experiment channel statistics (counterpart of ``rxtpu/data/stats.py``):
the streaming pass that computes them, its numpy reference, the
re-normalization check, and the artifact's JSON / pickle IO.

Math as the reference's offline loop: pixels scaled by 1/255,
``std = sqrt(E[x^2] - E[x]^2)`` per (experiment, channel).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Iterable, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Stats = Dict[str, Dict[str, np.ndarray]]
NB_CHANNELS = 6

# Pixels per partial sum: 256 uint8 pixels bound a chunk's sum of squares
# by 256 * 255^2 < 2^24, so the int32 sums are exact; everything lossy
# happens in f64 on the host.
_CHUNK = 256


def _partial_sums(images: torch.Tensor) -> torch.Tensor:
    """uint8 [N, H, W] -> int32 [N, n_chunks, 2]: exact (sum v, sum v^2) over
    chunks of 256 pixels (zero padding adds nothing)."""
    n = images.shape[0]
    v = images.reshape(n, -1).to(torch.int32)
    n_chunks = -(-v.shape[1] // _CHUNK)
    pad = n_chunks * _CHUNK - v.shape[1]
    if pad:
        v = torch.nn.functional.pad(v, (0, pad))
    v = v.reshape(n, n_chunks, _CHUNK)
    return torch.stack([v.sum(-1, dtype=torch.int32), (v * v).sum(-1, dtype=torch.int32)],
                       dim=-1)


def compute_stats_streaming(batches: Iterable[Tuple[Union[np.ndarray, torch.Tensor],
                                                    np.ndarray]],
                            experiments: Sequence[str], device="cpu") -> Stats:
    """One streaming pass over decoded images.

    ``batches`` yields ``(images uint8 [N, H, W], bucket_ids int32 [N])`` with
    ``bucket_id = experiment_index * 6 + channel - 1``, or -1 for a padded
    row. The chunk sums run on ``device`` (where the images already lie, if
    they are a tensor); the host accumulates them in int64 and f64 in
    rxtpu's order, so the result equals rxtpu's bit for bit. Returns
    ``{experiment: {"mean": [6], "std": [6]}}``; an empty bucket gives NaN.
    """
    n_buckets = len(experiments) * NB_CHANNELS
    acc = np.zeros((n_buckets, 3), dtype=np.float64)  # count, sum_x, sum_x2
    for images, bucket_ids in batches:
        valid = bucket_ids >= 0
        npix = int(np.prod(images.shape[1:]))
        parts = _partial_sums(torch.as_tensor(images, device=device)).cpu().numpy()
        per_img = parts.astype(np.int64).sum(axis=1)  # [N, 2] exact
        ids = bucket_ids[valid]
        np.add.at(acc[:, 0], ids, float(npix))
        np.add.at(acc[:, 1], ids, per_img[valid, 0] / 255.0)
        np.add.at(acc[:, 2], ids, per_img[valid, 1] / (255.0 * 255.0))
    count = acc[:, 0].reshape(len(experiments), NB_CHANNELS)
    sum_x = acc[:, 1].reshape(len(experiments), NB_CHANNELS)
    sum_x2 = acc[:, 2].reshape(len(experiments), NB_CHANNELS)
    out: Stats = {}
    with np.errstate(invalid="ignore", divide="ignore"):
        for i, exp in enumerate(experiments):
            mean = sum_x[i] / count[i]
            out[exp] = {"mean": mean, "std": np.sqrt(sum_x2[i] / count[i] - mean**2)}
    return out


def _normalized_moments(images_by_bucket: Iterator[Tuple[str, int, np.ndarray]],
                        stats: Optional[Stats] = None) -> Stats:
    acc: Dict[str, np.ndarray] = {}
    for exp, channel, img in images_by_bucket:
        a = acc.setdefault(exp, np.zeros((NB_CHANNELS, 3), dtype=np.float64))
        c = channel - 1
        x = np.asarray(img).astype(np.float64) / 255.0
        if stats is not None:
            x = (x - stats[exp]["mean"][c]) / stats[exp]["std"][c]
        a[c, 0] += x.size
        a[c, 1] += x.sum()
        a[c, 2] += (x**2).sum()
    out: Stats = {}
    for exp, a in acc.items():
        mean = a[:, 1] / a[:, 0]
        out[exp] = {"mean": mean, "std": np.sqrt(a[:, 2] / a[:, 0] - mean**2)}
    return out


def compute_stats_numpy(images_by_bucket: Iterator[Tuple[str, int, np.ndarray]]) -> Stats:
    """The host reference, image by image in f64: takes ``(experiment,
    channel_1based, uint8 image)`` triples."""
    return _normalized_moments(images_by_bucket)


def verify_stats(stats: Stats, images_by_bucket: Iterator[Tuple[str, int, np.ndarray]]
                 ) -> Stats:
    """Mean and std of the images normalized by ``stats``: about 0 and 1 per
    channel when the stats are right."""
    return _normalized_moments(images_by_bucket, stats)


def channel_from_path(path: str) -> int:
    """``{well}_s{site}_w{channel}.{ext}`` -> the 1-based channel."""
    return int(os.path.basename(path).split("_")[2][1])


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
