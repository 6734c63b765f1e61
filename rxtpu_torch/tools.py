"""Offline data tools of the port (counterpart of ``rxtpu/tools.py``): the
per-experiment stats pass.

``python -m rxtpu_torch.tools stats --data data [--out stats_experiments.json]``
    walks ``data/{train,test}/{experiment}/Plate*/*.jpeg``, decodes in
    batches of 256 with the port's JPEG decoder (``nthreads`` threads; on
    the card with nvJPEG unless ``--device cpu``) and accumulates each
    (experiment, channel)'s mean and std in one streaming pass;
    ``--verify`` prints the re-normalized moments (mean ~0, std ~1).

``pack``, ``png2jpeg`` and ``iobench`` are not ported yet.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from rxtpu_torch.data.decode import decode_files, jpeg_size
from rxtpu_torch.data.stats import (
    NB_CHANNELS, channel_from_path, compute_stats_streaming, save_stats, verify_stats,
)


def list_experiments(data_dir: str) -> List[str]:
    """Experiment names under ``data/{train,test}/*/``, first appearance kept."""
    exps: Dict[str, None] = {}
    for split in ("train", "test"):
        for p in sorted(glob.glob(os.path.join(data_dir, split, "*", ""))):
            exps.setdefault(os.path.basename(os.path.dirname(p)), None)
    return list(exps)


def experiment_paths(data_dir: str, experiment: str, ext: str) -> List[str]:
    return sorted(glob.glob(os.path.join(data_dir, "*", experiment, "*", f"*.{ext}")))


def _probe_size(path: str, device="cpu") -> int:
    """The side of the square images, from the first file's JPEG header."""
    h, w = jpeg_size(path, device)
    if h != w:
        raise ValueError(f"{path}: {h}x{w} image, expected a square one")
    return h


def _stats_batches(data_dir: str, experiments: Sequence[str], ext: str, size: int,
                   batch: int, nthreads: int = 0, device="cpu"
                   ) -> Iterator[Tuple[object, np.ndarray]]:
    exp_ix = {e: i for i, e in enumerate(experiments)}
    todo: List[Tuple[str, int]] = []
    for exp in experiments:
        for p in experiment_paths(data_dir, exp, ext):
            todo.append((p, exp_ix[exp] * NB_CHANNELS + channel_from_path(p) - 1))
    for i in range(0, len(todo), batch):
        chunk = todo[i:i + batch]
        paths = [p for p, _ in chunk]
        ids = np.full(batch, -1, np.int32)
        for j, (_, bucket) in enumerate(chunk):
            ids[j] = bucket
        paths += [paths[0]] * (batch - len(paths))  # padding, masked by id -1
        yield decode_files(paths, size, size, nthreads=nthreads, strict=True,
                           device=device), ids


def run_stats(data_dir: str, out_path: str, ext: str = "jpeg", batch: int = 256,
              verify: bool = False, nthreads: int = 0, device="cpu") -> Dict:
    """Compute the stats artifact of ``data_dir``'s JPEG tree, write it to
    ``out_path`` (JSON) and return it."""
    experiments = list_experiments(data_dir)
    if not experiments:
        raise SystemExit(f"no experiments found under {data_dir}/{{train,test}}/")
    first = experiment_paths(data_dir, experiments[0], ext)
    if not first:
        raise SystemExit(f"no .{ext} images for experiment {experiments[0]}")
    size = _probe_size(first[0], device)
    stats = compute_stats_streaming(
        _stats_batches(data_dir, experiments, ext, size, batch, nthreads, device),
        experiments, device)
    save_stats(stats, out_path)
    print(f"wrote {out_path} ({len(experiments)} experiments, size {size})")
    if verify:
        def triples():
            for exp in experiments:
                for p in experiment_paths(data_dir, exp, ext):
                    img = decode_files([p], size, size, nthreads=1, strict=True, device=device)
                    if isinstance(img, torch.Tensor):
                        img = img.cpu().numpy()
                    yield exp, channel_from_path(p), img[0]

        ver = verify_stats(stats, triples())
        print("Verification:")
        for exp in experiments:
            print("mean=", ver[exp]["mean"])
            print("std=", ver[exp]["std"])
    return stats


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="rxtpu_torch.tools")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("stats", help="streaming per-experiment mean/std pass")
    sp.add_argument("--data", default="data")
    sp.add_argument("--out", default="stats_experiments.json")
    sp.add_argument("--ext", default="jpeg")
    sp.add_argument("--batch", type=int, default=256)
    sp.add_argument("--threads", type=int, default=0)
    sp.add_argument("--verify", action="store_true")
    sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from rxtpu_torch.config import resolve_device

    run_stats(args.data, args.out, args.ext, args.batch, args.verify, args.threads,
              resolve_device(args.device))


if __name__ == "__main__":
    main()
