"""Offline data tools of the port (counterpart of ``rxtpu/tools.py``), with
no JAX and no cv2. Every subcommand takes ``--device`` (``cuda``, the
default, or ``cpu``): JPEGs decode and encode with nvJPEG on the card,
libjpeg on the CPU; PNGs and the packs' codecs are host work either way.

``python -m rxtpu_torch.tools stats --data data [--out stats_experiments.json] [--ext png]``
    walks ``data/{train,test}/{experiment}/Plate*/*.{ext}``, decodes in
    batches of 256 (``--threads`` threads) and accumulates each
    (experiment, channel)'s mean and std in one streaming pass;
    ``--verify`` prints the re-normalized moments (mean ~0, std ~1).

``python -m rxtpu_torch.tools pack --data data --out packs [--ext png] [--compress zstd --filter png]``
    decodes every (well, site) of each split once into an rxpack
    (``data/pack.py`` ``write_pack``, rxtpu's format and bytes): raw, or
    one zlib or zstd stream per view (levels 6 and 19 unless
    ``--compress-level``), optionally row-filtered first.

``python -m rxtpu_torch.tools png2jpeg --data data [--quality 95]``
    converts every ``.png`` under the data dir to a grayscale JPEG beside it.

``python -m rxtpu_torch.tools iobench --data data [--ext png]``
    the host's decode rate of one split's files, and the input stall that
    rate implies against the card's train rate (``--train-views-per-s``).
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from rxtpu_torch.config import resolve_device
from rxtpu_torch.data.decode import decode_files, encode_batch_jpeg, image_size, png_size
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


# The port's train rate on the card: the bf16 B=16 ResNet-50 train step with
# the batch on the card, 395.9 views/s on an NVIDIA H100 80GB HBM3 at
# 700.00 W (PERF.md section 5, chip_smoke.py phase 7).
H100_TRAIN_VIEWS_PER_S = 395.9


def _probe_size(path: str, device="cpu") -> int:
    """The side of the square images, from the first file's header."""
    h, w = image_size(path, device)
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
              verify: bool = False, nthreads: int = 0, device="cuda") -> Dict:
    """Compute the stats artifact of ``data_dir``'s JPEG or PNG tree, write it
    to ``out_path`` (JSON) and return it; on the card unless ``device="cpu"``."""
    device = resolve_device(device)
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


def run_png2jpeg(data_dir: str, quality: int = 95, batch: int = 256, nthreads: int = 0,
                 device="cuda") -> int:
    """Write a grayscale JPEG at ``quality`` beside every ``.png`` under
    ``data_dir`` (rxtpu's bytes on the CPU); returns the number converted.
    Every PNG must have the first one's size: a stray PNG of another size
    under the data dir stops the run, naming it, before its batch is
    written. Decodes on the card unless ``device="cpu"``."""
    device = resolve_device(device)
    paths = sorted(glob.glob(os.path.join(data_dir, "**", "*.png"), recursive=True))
    n_done = 0
    expect = None
    for i in range(0, len(paths), batch):
        chunk = paths[i:i + batch]
        for p in chunk:
            try:
                size = png_size(p)
            except (OSError, ValueError):
                raise SystemExit(f"png2jpeg: cannot read {p}") from None
            if expect is None:
                expect = size
            elif size != expect:
                raise SystemExit(f"png2jpeg: {p} has size {size}, expected {expect} "
                                 "(non-dataset png under the data dir?)")
        try:
            planes = decode_files(chunk, *expect, nthreads=nthreads, strict=True,
                                  device=device)
        except ValueError:
            for p in chunk:  # name the first file that does not decode
                try:
                    decode_files([p], *expect, nthreads=1, strict=True, device=device)
                except ValueError as e:
                    raise SystemExit(f"png2jpeg: cannot read {p}: {e}") from None
            raise
        bufs = encode_batch_jpeg(planes, quality=quality, nthreads=nthreads)
        for p, buf in zip(chunk, bufs):
            with open(p.rsplit(".", 1)[0] + ".jpeg", "wb") as f:
                f.write(buf)
            n_done += 1
    print(f"converted {n_done} png -> jpeg (quality {quality})")
    return n_done


def run_iobench(data_dir: str, ext: str = "jpeg", batch: int = 288, nthreads: int = 0,
                seconds: float = 5.0, train_views_per_s: float = H100_TRAIN_VIEWS_PER_S,
                device="cuda") -> Dict:
    """The decode rate of the first experiments' files (at least ``batch``
    x 4 of them), ``batch`` files per call for ``seconds`` after one warm-up
    call, on ``device``.

    A view is 6 files, so the supply is ``views_per_s_supported = rate / 6``;
    against the card's consumption ``train_views_per_s`` (default the port's
    measured H100 train step, ``H100_TRAIN_VIEWS_PER_S``) the decode-bound
    input stall is ``max(0, 1 - supply / demand)``.
    """
    exps = list_experiments(data_dir)
    paths: List[str] = []
    for e in exps:
        paths += experiment_paths(data_dir, e, ext)
        if len(paths) >= batch * 4:
            break
    if not paths:
        raise SystemExit(f"no .{ext} files under {data_dir}")
    device = resolve_device(device)
    size = _probe_size(paths[0], device)

    def decode(chunk):
        decode_files(chunk, size, size, nthreads=nthreads, strict=True, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    decode(paths[:batch])
    n_done, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        decode([paths[(n_done + i) % len(paths)] for i in range(batch)])
        n_done += batch
    rate = n_done / (time.perf_counter() - t0)
    supply = rate / 6.0
    out = {
        "decode_images_per_s": round(rate, 1),
        "image_size": size,
        "threads": nthreads or os.cpu_count(),
        "views_per_s_supported": round(supply, 1),
        "projected_decode_stall_pct": round(
            100.0 * max(0.0, 1.0 - supply / train_views_per_s), 1),
        "train_views_per_s": train_views_per_s,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    print(out)
    return out


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

    pk = sub.add_parser("pack", help="write decode-free rxpack dataset files")
    pk.add_argument("--data", default="data")
    pk.add_argument("--out", default="packs")
    pk.add_argument("--ext", default="jpeg")
    pk.add_argument("--threads", type=int, default=0)
    pk.add_argument("--splits", default="train,test")
    pk.add_argument("--compress", default="none", choices=["none", "zlib", "zstd"],
                    help="lossless per-view compression: a smaller pack for "
                         "storage-bandwidth-bound hosts; readers decompress in the "
                         "native pool (zstd faster than zlib)")
    pk.add_argument("--compress-level", type=int, default=None,
                    help="codec scale: zlib 1-9 (default 6), zstd 1-22 (default 19)")
    pk.add_argument("--filter", default="none", choices=["none", "png"],
                    help="png: per-row adaptive pre-filter before the codec")

    ib = sub.add_parser("iobench", help="host decode-throughput benchmark")
    ib.add_argument("--data", default="data")
    ib.add_argument("--ext", default="jpeg")
    ib.add_argument("--batch", type=int, default=288)
    ib.add_argument("--threads", type=int, default=0)
    ib.add_argument("--seconds", type=float, default=5.0)
    ib.add_argument("--train-views-per-s", type=float, default=H100_TRAIN_VIEWS_PER_S,
                    help="the card's train rate the decode must supply (default: the "
                         "port's measured rate on an NVIDIA H100 80GB HBM3 at 700 W)")

    cp = sub.add_parser("png2jpeg", help="batch convert PNGs to grayscale JPEG")
    cp.add_argument("--data", default="data")
    cp.add_argument("--quality", type=int, default=95)
    cp.add_argument("--batch", type=int, default=256)
    cp.add_argument("--threads", type=int, default=0)
    for p in (sp, pk, ib, cp):
        p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.cmd == "stats":
        run_stats(args.data, args.out, args.ext, args.batch, args.verify, args.threads, device)
    elif args.cmd == "pack":
        from rxtpu_torch.data.pack import write_pack
        from rxtpu_torch.data.records import load_metadata, read_metadata_csvs

        level = args.compress_level
        if level is None:
            level = 19 if args.compress == "zstd" else 6
        for split in args.splits.split(","):
            rows, controls = read_metadata_csvs(os.path.join(args.data, "metadata"), split)
            path = write_pack(load_metadata(rows, controls, split), args.data, args.out,
                              ext=args.ext, decoder_threads=args.threads, verbose=True,
                              compress=None if args.compress == "none" else args.compress,
                              compress_level=level,
                              filter=None if args.filter == "none" else args.filter,
                              device=device)
            print(f"wrote {path} ({os.path.getsize(path) / 1e6:.1f} MB)")
    elif args.cmd == "iobench":
        run_iobench(args.data, args.ext, args.batch, args.threads, args.seconds,
                    args.train_views_per_s, device)
    else:
        run_png2jpeg(args.data, args.quality, args.batch, args.threads, device)


if __name__ == "__main__":
    main()
