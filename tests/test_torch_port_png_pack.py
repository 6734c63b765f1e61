"""rxtpu_torch's PNG input and compressed packs against rxtpu's, on the CPU.

- the row filter (``filter_plane_py`` / ``unfilter_plane_py`` and the
  native filter and unfilter of ``csrc/inflate_host.cpp``) against rxtpu's,
  bit for bit;
- ``deflate_filtered_batch`` byte-equal to rxtpu's for zlib and zstd, with
  and without the filter; ``inflate_batch`` / ``inflate_unfilter_batch``
  round trips, and corrupt and truncated streams (zero-fill, or rxtpu's
  ``ValueError`` with ``strict=True``); a codec library the host lacks
  raises and names it;
- the PNG reader against cv2 (rxtpu's reader) on cv2's files at every
  compression level and strategy, with IDAT split into small chunks, on a
  file that uses each of the five filters, and against ``png_decode_py``; a
  bad CRC, a wrong size and a truncated file fail; each unsupported kind
  (colour, palette, gray with alpha, 16-bit, interlaced) raises;
- ``write_pack`` (raw, zlib, zstd, zlib+png) from a PNG and from a JPEG tree
  byte-equal to rxtpu's, and ``PackStore`` and Pipeline batches equal to
  rxtpu's; the Pipeline from a PNG tree, preloaded and streaming;
- ``run_png2jpeg``, ``run_stats --ext png`` and ``iobench`` against rxtpu's,
  and ``write_png_tree``'s files read back by cv2;
- the slice as a whole: on a random rxtpu checkpoint, the port's CLI from
  the PNG tree (no ``--pack``, stats computed) and from a zlib+png pack
  writes the submission rxtpu's CLI writes from its pack, byte for byte;
- on a card (``gpu``-marked): PNG and mixed batches and compressed-pack
  batches on the card equal the CPU's.
"""

from __future__ import annotations

import glob
import os
import shutil
import struct
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch

import rxtpu.cli as rx_cli
from rxtpu.data import decode as rx
from rxtpu.data.pack import PackStore as RxPackStore
from rxtpu.data.pack import write_pack as rx_write_pack
from rxtpu.data.pipeline import ByteStore as RxByteStore
from rxtpu.data.pipeline import Pipeline as RxPipeline
from rxtpu.data.records import load_metadata as rx_load_metadata
from rxtpu.data.records import read_metadata_csvs as rx_read_metadata_csvs
from rxtpu.data.synthetic import (
    cells_image, make_plate_balanced_synthetic_dataset, make_synthetic_dataset,
)
from rxtpu.tools import main as rx_tools_main
from rxtpu.tools import run_iobench as rx_run_iobench
from rxtpu.tools import run_png2jpeg as rx_run_png2jpeg
from rxtpu.tools import run_stats as rx_run_stats
from rxtpu_torch import cli as port_cli
from rxtpu_torch import tools as port_tools
from rxtpu_torch.data import decode as d
from rxtpu_torch.data.pack import PackStore, write_pack
from rxtpu_torch.data.pipeline import ByteStore, Pipeline
from rxtpu_torch.data.records import load_metadata, read_metadata_csvs
from rxtpu_torch.data.synthetic import make_train_fixture, png_bytes, write_png_tree

SRC = 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {"raw": {}, "zlib": {"compress": "zlib"}, "zstd": {"compress": "zstd"},
         "zlib+png": {"compress": "zlib", "filter": "png"}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run as fast on one intra-op thread, and the suite runs
    test files in parallel workers that would otherwise contend for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def png_root(tmp_path_factory):
    """rxtpu's miniature dataset written as PNGs by cv2 (rxtpu's writer)."""
    root = str(tmp_path_factory.mktemp("pngdata"))
    make_synthetic_dataset(root, ext="png")
    return root


def _planes(n=6, seed=0, size=SRC):
    """Microscopy-like planes, a uniform random one, a constant one and a
    ramp (long runs and exact ties for the filter heuristic)."""
    rng = np.random.default_rng(seed)
    cells = [cells_image(rng, size, 3 + i, 1 + i % 6) for i in range(n)]
    ramp = np.add.outer(np.arange(size), np.arange(size)).astype(np.uint8)
    return np.stack(cells + [rng.integers(0, 256, (size, size), dtype=np.uint8),
                             np.full((size, size), 77, np.uint8), ramp])


def _views(seed=0):
    return _planes(seed=seed).reshape(-1, 3, SRC, SRC)  # 3 views of 3 planes


def _blob(streams):
    """Streams laid out with a gap before each, as in a buffer of many."""
    gap = b"\x00" * 7
    data = b"".join(gap + s for s in streams)
    lengths = np.array([len(s) for s in streams], np.int64)
    offsets = np.cumsum(lengths + len(gap)) - lengths
    return np.frombuffer(data, np.uint8), offsets, lengths


def _stats(experiments, seed=0):
    rng = np.random.default_rng(seed)
    return {e: {"mean": rng.uniform(0.2, 0.6, 6), "std": rng.uniform(0.1, 0.3, 6)}
            for e in experiments}


def _index_pair(root, split):
    rows, ctrl = rx_read_metadata_csvs(os.path.join(root, "metadata"), split)
    port_rows, port_ctrl = read_metadata_csvs(os.path.join(root, "metadata"), split)
    return rx_load_metadata(rows, ctrl, split), load_metadata(port_rows, port_ctrl, split)


def _split_idat(png: bytes, size: int) -> bytes:
    """The same PNG with its IDAT data in chunks of ``size`` bytes and an
    ancillary chunk between two of them."""
    chunks, pos, idat = [], 8, b""
    while pos < len(png):
        (n,) = struct.unpack(">I", png[pos:pos + 4])
        kind, data = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + n]
        chunks.append((kind, data))
        idat += data if kind == b"IDAT" else b""
        pos += 12 + n

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data))

    parts = [chunk(b"IDAT", idat[i:i + size]) for i in range(0, len(idat), size)]
    parts.insert(1, chunk(b"tEXt", b"Comment\x00split"))
    head = b"".join(chunk(k, v) for k, v in chunks if k == b"IHDR")
    return d.PNG_MAGIC + head + b"".join(parts) + chunk(b"IEND", b"")


def _with_ihdr(png: bytes, colour: int = 0, interlace: int = 0) -> bytes:
    """``png`` (8-bit gray) with IHDR's colour type and interlace method
    replaced and its CRC recomputed."""
    w, h, depth, _, method, filt, _ = struct.unpack(">IIBBBBB", png[16:29])
    ihdr = b"IHDR" + struct.pack(">IIBBBBB", w, h, depth, colour, method, filt, interlace)
    return png[:12] + ihdr + struct.pack(">I", zlib.crc32(ihdr)) + png[33:]


# ---- the row filter and the codecs -------------------------------------------

def test_filter_plane_py_bit_equal_to_rxtpu():
    planes = list(_planes()) + [_planes(size=37)[0][:23], _planes(size=8)[-1][:1]]
    for p in planes:
        filt = d.filter_plane_py(p)
        np.testing.assert_array_equal(filt, rx.filter_plane_py(p))
        assert set(np.unique(filt[:, 0])) <= set(range(5))
        np.testing.assert_array_equal(d.unfilter_plane_py(filt), p)
        np.testing.assert_array_equal(d.unfilter_plane_py(filt), rx.unfilter_plane_py(filt))
    bad = d.filter_plane_py(planes[0])
    bad[3, 0] = 5
    with pytest.raises(ValueError, match="corrupt filter id 5 at row 3"):
        d.unfilter_plane_py(bad)


def test_native_filter_and_unfilter_bit_equal_to_rxtpu():
    """The native filter is what zlib holds in a filtered stream; the native
    unfilter inverts rows of every filter id, and a bad id fails."""
    views = _views()
    streams = d.deflate_filtered_batch(views, level=6, use_filter=True, nthreads=2)
    for v, s in zip(views, streams):
        rows = np.frombuffer(zlib.decompress(s), np.uint8).reshape(3, SRC, SRC + 1)
        for p in range(3):
            np.testing.assert_array_equal(rows[p], rx.filter_plane_py(v[p]))
    rng = np.random.default_rng(1)
    handmade = rng.integers(0, 256, (4, 2, SRC, SRC + 1), dtype=np.uint8)
    handmade[..., 0] = np.arange(SRC) % 5  # every filter id, in turn
    handmade[3, 1, 9, 0] = 7  # a corrupt id in the last view
    data, offsets, lengths = _blob([zlib.compress(v.tobytes()) for v in handmade])
    got = d.inflate_unfilter_batch(data, offsets, lengths, 2, SRC, SRC, nthreads=3)
    want = rx.inflate_unfilter_batch(data, offsets, lengths, 2, SRC, SRC)
    np.testing.assert_array_equal(got, want)
    for i in range(3):
        for p in range(2):
            np.testing.assert_array_equal(got[i, p], rx.unfilter_plane_py(handmade[i, p]))
    assert not got[3].any()
    with pytest.raises(ValueError, match="1/4 records failed to decompress"):
        d.inflate_unfilter_batch(data, offsets, lengths, 2, SRC, SRC, strict=True)


@pytest.mark.parametrize("use_filter", [False, True])
@pytest.mark.parametrize("codec", ["zlib", "zstd"])
def test_deflate_bytes_equal_rxtpu(codec, use_filter):
    views = _views()
    for level in (1, 6, 19 if codec == "zstd" else 9):
        want = rx.deflate_filtered_batch(views, level=level, use_filter=use_filter,
                                         codec=codec)
        for nthreads in (1, 3):
            assert d.deflate_filtered_batch(views, level, use_filter, nthreads, codec) == want
    assert d.deflate_filtered_batch(views[:0], codec=codec) == []


@pytest.mark.parametrize("use_filter", [False, True])
@pytest.mark.parametrize("codec", ["zlib", "zstd"])
def test_inflate_round_trip_and_failures_as_rxtpu(codec, use_filter, tmp_path):
    views = _views()
    streams = d.deflate_filtered_batch(views, 3, use_filter, codec=codec)
    other = d.deflate_filtered_batch(views[:1, :2], 3, use_filter, codec=codec)[0]
    flipped = bytearray(streams[1])
    flipped[0] ^= 0xFF  # the header (a zstd frame without a checksum may take a flip inside)
    bad = [streams[0], bytes(flipped), streams[2][:-9], other, streams[2], b""]
    if use_filter:
        def inflate(mod, *args, **kw):
            return mod.inflate_unfilter_batch(*args, 3, SRC, SRC, codec=codec, **kw)
    else:
        def inflate(mod, *args, **kw):
            return mod.inflate_batch(*args, 3 * SRC * SRC, codec=codec, **kw).reshape(
                -1, 3, SRC, SRC)
    blob = _blob(streams)
    np.testing.assert_array_equal(inflate(d, *blob, nthreads=2), views)
    # the pack's memmap goes to the pool as it is
    path = tmp_path / "streams.bin"
    path.write_bytes(blob[0].tobytes())
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    assert np.shares_memory(np.ascontiguousarray(mm), mm)
    np.testing.assert_array_equal(inflate(d, mm, *blob[1:], strict=True), views)
    got = inflate(d, *_blob(bad), nthreads=3)
    np.testing.assert_array_equal(got, inflate(rx, *_blob(bad)))
    assert got[0].any() and got[4].any() and not got[1:4].any() and not got[5].any()
    with pytest.raises(ValueError, match="4/6 records failed to decompress"):
        inflate(d, *_blob(bad), strict=True)
    with pytest.raises(ValueError, match="4/6 records failed to decompress"):
        inflate(rx, *_blob(bad), strict=True)
    data, offsets, lengths = blob
    with pytest.raises(ValueError, match="outside"):
        inflate(d, data[:-3], offsets, lengths)
    assert inflate(d, data, offsets[:0], lengths[:0]).shape == (0, 3, SRC, SRC)


def test_codec_errors_name_what_is_missing():
    with pytest.raises(ValueError, match="unknown codec 'lz4'"):
        d.deflate_filtered_batch(_views(), codec="lz4")
    # a host without libzstd.so.1: the same call under another soname, in a
    # fresh process (a bound library stays bound for the process)
    code = ("from rxtpu_torch.data import decode as d, pack\n"
            "d.CODEC_LIBRARIES['zstd'] = 'libzstd_absent.so.1'\n"
            "d.load_codec('zlib')\n"
            "import numpy as np\n"
            "try:\n"
            "    d.inflate_batch(np.zeros(8, np.uint8), [0], [8], 8, codec='zstd')\n"
            "except RuntimeError as e:\n"
            "    print(e)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "the zstd codec needs libzstd_absent.so.1" in out.stdout
    assert "cannot open shared object file" in out.stdout


# ---- the PNG reader ------------------------------------------------------------

@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_png_reader_bit_equal_to_cv2(level, tmp_path):
    planes = _planes()
    rect = _planes(size=56)[:3, :40]  # 40 x 56
    for strategy in (cv2.IMWRITE_PNG_STRATEGY_DEFAULT, cv2.IMWRITE_PNG_STRATEGY_FILTERED,
                     cv2.IMWRITE_PNG_STRATEGY_HUFFMAN_ONLY, cv2.IMWRITE_PNG_STRATEGY_RLE,
                     cv2.IMWRITE_PNG_STRATEGY_FIXED):
        params = [cv2.IMWRITE_PNG_COMPRESSION, level, cv2.IMWRITE_PNG_STRATEGY, strategy]
        for group in (planes, rect):
            pngs = [cv2.imencode(".png", p, params)[1].tobytes() for p in group]
            want = np.stack([cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_GRAYSCALE)
                             for b in pngs])
            np.testing.assert_array_equal(want, group)
            h, w = group.shape[1:]
            np.testing.assert_array_equal(d.decode_batch(pngs, h, w, nthreads=2, strict=True),
                                          want)
            small = [_split_idat(b, 97) for b in pngs]
            np.testing.assert_array_equal(d.decode_batch(small, h, w, strict=True), want)
            for b, s, p in zip(pngs[:2], small[:2], group):
                np.testing.assert_array_equal(d.png_decode_py(b), p)
                np.testing.assert_array_equal(d.png_decode_py(s), p)
    paths = []
    for i, b in enumerate(pngs):
        paths.append(str(tmp_path / f"p{i}.png"))
        with open(paths[-1], "wb") as f:
            f.write(_split_idat(b, 50))
    for nthreads in (1, 4):
        np.testing.assert_array_equal(d.decode_files(paths, 40, 56, nthreads, strict=True),
                                      rect)
    assert d.png_size(paths[0]) == d.image_size(paths[0]) == (40, 56)


def test_png_reader_on_rxtpus_png_tree(png_root):
    tree = sorted(glob.glob(os.path.join(png_root, "*", "*", "*", "*.png")))
    assert len(tree) > 100
    want = rx.decode_files(tree, SRC, SRC, strict=True)  # cv2.imread
    np.testing.assert_array_equal(d.decode_files(tree, SRC, SRC, strict=True), want)
    bufs = [open(p, "rb").read() for p in tree[:40]]
    np.testing.assert_array_equal(d.decode_batch(bufs, SRC, SRC, nthreads=3, strict=True),
                                  want[:40])
    np.testing.assert_array_equal(d.png_decode_py(bufs[0]), want[0])


def test_png_every_filter_type():
    """A handmade file whose rows use the five filters in turn: the reader,
    the plain reader and cv2 agree with the plain unfilter."""
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 256, (SRC, SRC + 1), dtype=np.uint8)
    rows[:, 0] = np.arange(SRC) % 5
    want = d.unfilter_plane_py(rows)
    png = png_bytes(zlib.compress(rows.tobytes(), 9), SRC, SRC)
    np.testing.assert_array_equal(d.decode_batch([png], SRC, SRC, strict=True)[0], want)
    np.testing.assert_array_equal(d.png_decode_py(png), want)
    np.testing.assert_array_equal(
        cv2.imdecode(np.frombuffer(png, np.uint8), cv2.IMREAD_GRAYSCALE), want)


def test_png_failures_zero_fill_or_raise(tmp_path):
    good = cv2.imencode(".png", _planes(1)[0])[1].tobytes()
    idat_crc, ihdr_crc = bytearray(good), bytearray(good)
    idat_crc[-20] ^= 1  # inside IDAT's data
    ihdr_crc[20] ^= 1   # IHDR's height
    bad_filter = png_bytes(zlib.compress(np.full((SRC, SRC + 1), 9, np.uint8).tobytes()),
                           SRC, SRC)
    short = png_bytes(zlib.compress(b"\x00" * (SRC * (SRC + 1) - 1)), SRC, SRC)
    cases = [bytes(idat_crc), bytes(ihdr_crc), good[:-12], good[:50], b"", b"not a png",
             bad_filter, short, _split_idat(good, 64)[:-12]]
    bufs = [good] + cases + [good]
    got = d.decode_batch(bufs, SRC, SRC, nthreads=2)
    assert got[0].any() and got[-1].any() and not got[1:-1].any()
    with pytest.raises(ValueError, match=f"{len(cases)}/{len(bufs)} images failed"):
        d.decode_batch(bufs, SRC, SRC, strict=True)
    for buf in cases:
        with pytest.raises(ValueError):
            d.png_decode_py(buf)
    # the wrong size fails like a corrupt file, as in rxtpu
    np.testing.assert_array_equal(d.decode_batch([good], SRC, SRC + 8),
                                  rx.decode_batch([good], SRC, SRC + 8))
    paths = [str(tmp_path / "a.png"), str(tmp_path / "missing.png")]
    with open(paths[0], "wb") as f:
        f.write(good)
    got = d.decode_files(paths, SRC, SRC)
    assert got[0].any() and not got[1].any()
    with pytest.raises(ValueError, match="1/2 files failed to read/decode"):
        d.decode_files(paths, SRC, SRC, strict=True)
    with pytest.raises(ValueError, match="only JPEG .* and PNG"):
        d.decode_files([str(tmp_path / "a.tif")], SRC, SRC)
    for buf in (good[:20], bytes(ihdr_crc)):
        with open(paths[0], "wb") as f:
            f.write(buf)
        with pytest.raises(ValueError, match="not a readable PNG header"):
            d.png_size(paths[0])


@pytest.mark.parametrize("kind", ["colour", "palette", "gray+alpha", "16-bit", "interlaced"])
def test_png_unsupported_kind_raises(kind, tmp_path):
    """rxtpu (cv2) converts these kinds; the port raises, strict or not."""
    plane = _planes(1)[0]
    gray = cv2.imencode(".png", plane)[1].tobytes()
    png = {
        "colour": lambda: cv2.imencode(".png", np.stack([plane] * 3, -1))[1].tobytes(),
        "palette": lambda: _with_ihdr(gray, colour=3),
        "gray+alpha": lambda: _with_ihdr(gray, colour=4),
        "16-bit": lambda: cv2.imencode(".png", plane.astype(np.uint16) * 257)[1].tobytes(),
        "interlaced": lambda: _with_ihdr(gray, interlace=1),
    }[kind]()
    with pytest.raises(ValueError, match="buffer 1 .*8-bit grayscale PNGs without interlace"):
        d.decode_batch([gray, png], SRC, SRC)
    path = str(tmp_path / "x_s1_w1.png")
    with open(path, "wb") as f:
        f.write(png)
    with pytest.raises(ValueError, match="x_s1_w1.png .*1/1 PNGs"):
        d.decode_files([path], SRC, SRC, strict=False)
    with pytest.raises(ValueError, match="unsupported PNG"):
        d.png_decode_py(png)


def test_mixed_jpeg_png_batches_equal_rxtpu(png_root, synthetic_root, tmp_path):
    pngs = sorted(glob.glob(os.path.join(png_root, "train", "*", "*", "*.png")))[:6]
    jpegs = sorted(glob.glob(os.path.join(synthetic_root[0], "train", "*", "*",
                                          "*.jpeg")))[:6]
    paths = [p for pair in zip(pngs, jpegs) for p in pair]
    want = rx.decode_files(paths, SRC, SRC, strict=True)
    np.testing.assert_array_equal(d.decode_files(paths, SRC, SRC, 2, strict=True), want)
    bufs = [open(p, "rb").read() for p in paths] + [b""]
    got = d.decode_batch(bufs, SRC, SRC)
    np.testing.assert_array_equal(got, rx.decode_batch(bufs, SRC, SRC))
    np.testing.assert_array_equal(got[:-1], want)
    assert d.image_size(jpegs[0]) == d.image_size(pngs[0]) == (SRC, SRC)


# ---- packs ------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("ext", ["png", "jpeg"])
def test_write_pack_bytes_and_batches_equal_rxtpu(ext, mode, png_root, synthetic_root,
                                                  tmp_path):
    root = png_root if ext == "png" else synthetic_root[0]
    rx_index, index = _index_pair(root, "train")
    kw = dict(MODES[mode], compress_level=3 if mode == "zstd" else 6)
    want = rx_write_pack(rx_index, root, str(tmp_path / "rx"), ext=ext, **kw)
    got = write_pack(index, root, str(tmp_path / "port"), ext=ext, decoder_threads=2,
                     batch_wells=5, **kw)
    for suffix in ("", ".json"):
        with open(want + suffix, "rb") as a, open(got + suffix, "rb") as b:
            assert b.read() == a.read(), suffix
    store, rx_store = PackStore(got), RxPackStore(want)
    assert (store.compress, store.filter) == (rx_store.compress, rx_store.filter)
    keys = [(r, s) for r in index.records for s in (1, 2)][::-1]
    rx_keys = [(r, s) for r in rx_index.records for s in (1, 2)][::-1]
    batch = store.get_decoded_batch(keys, nthreads=3)
    assert batch.shape == (len(keys), 6, SRC, SRC)
    np.testing.assert_array_equal(batch, rx_store.get_decoded_batch(rx_keys, nthreads=2))
    raw = PackStore(write_pack(index, root, str(tmp_path / "raw"), ext=ext))
    np.testing.assert_array_equal(batch, raw.get_decoded_batch(keys))


def test_write_pack_checks_as_rxtpu(png_root, tmp_path):
    _, index = _index_pair(png_root, "train")
    with pytest.raises(ValueError, match="unknown pack compression 'lz4'"):
        write_pack(index, png_root, str(tmp_path), compress="lz4")
    with pytest.raises(ValueError, match="unknown pack filter 'gif'"):
        write_pack(index, png_root, str(tmp_path), compress="zlib", filter="gif")
    with pytest.raises(ValueError, match="filter requires a compress codec"):
        write_pack(index, png_root, str(tmp_path), filter="png")
    with pytest.raises(FileNotFoundError, match="cannot read probe image"):
        write_pack(index, png_root, str(tmp_path), ext="jpeg")
    # a corrupt source fails the pack, strictly
    victim = sorted(glob.glob(os.path.join(png_root, "train", "*", "*", "*.png")))[-1]
    broken = tmp_path / "tree"
    shutil.copytree(png_root, broken)
    target = broken / os.path.relpath(victim, png_root)
    target.write_bytes(target.read_bytes()[:60])
    with pytest.raises(ValueError, match="1/.* files failed to read/decode"):
        write_pack(index, str(broken), str(tmp_path / "out"), ext="png", src_size=SRC)


def test_packstore_fails_on_a_corrupt_record(png_root, tmp_path):
    _, index = _index_pair(png_root, "test")
    path = write_pack(index, png_root, str(tmp_path), ext="png", compress="zstd",
                      filter="png", compress_level=1)
    store = PackStore(path)
    keys = [(r, 1) for r in index.records]
    good = store.get_decoded_batch(keys)
    raw = bytearray(open(path, "rb").read())
    off = store._offsets[store._ordinal(*keys[1])]
    raw[off] ^= 0x55
    with open(path, "wb") as f:
        f.write(bytes(raw))
    with pytest.raises(ValueError, match="1/.* records failed to decompress"):
        PackStore(path).get_decoded_batch(keys)
    np.testing.assert_array_equal(PackStore(path).get_decoded_batch(keys[:1]), good[:1])


@pytest.mark.parametrize("preload", [True, False])
@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_png_bytestore_pipeline_bit_equal_to_rxtpu(png_root, mode, preload):
    rx_index, index = _index_pair(png_root, "test" if mode == "test" else "train")
    stats = _stats(sorted({r.experiment for r in index.records}))
    kw = dict(seed=5, shuffle=mode == "train", drop_last=mode == "train")
    rx_pipe = RxPipeline(rx_index, RxByteStore(rx_index, png_root, ext="png", preload=preload),
                         stats, 5, mode, SRC, decoder_threads=2, **kw)
    store = ByteStore(index, png_root, ext="png", preload=preload)
    pipe = Pipeline(index, store, stats, 5, mode, src_size=SRC, decoder_threads=2, **kw)
    assert len(pipe) == len(rx_pipe) >= 2
    for epoch in (0, 1):
        for g, w in zip(pipe.epoch(epoch), rx_pipe.epoch(epoch), strict=True):
            assert g["id_codes"] == w["id_codes"]
            for k in ("images", "labels", "mean", "std", "valid"):
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("mode", ["zstd", "zlib+png"])
def test_compressed_pack_pipeline_bit_equal_to_rxtpu(png_root, mode, tmp_path):
    rx_index, index = _index_pair(png_root, "train")
    kw = dict(MODES[mode], compress_level=1)
    rx_store = RxPackStore(rx_write_pack(rx_index, png_root, str(tmp_path / "rx"), ext="png",
                                         **kw))
    store = PackStore(write_pack(index, png_root, str(tmp_path / "port"), ext="png", **kw))
    stats = _stats(sorted({r.experiment for r in index.records}))
    rx_pipe = RxPipeline(rx_index, rx_store, stats, 4, "train", SRC, seed=2,
                         decoder_threads=3)
    pipe = Pipeline(index, store, stats, 4, "train", seed=2, decoder_threads=3)
    for g, w in zip(pipe.epoch(1), rx_pipe.epoch(1), strict=True):
        assert g["id_codes"] == w["id_codes"]
        np.testing.assert_array_equal(g["images"], w["images"])


# ---- tools ------------------------------------------------------------------------

def test_run_png2jpeg_bytes_equal_rxtpu(png_root, tmp_path):
    rx_dir, port_dir = tmp_path / "rx", tmp_path / "port"
    for out in (rx_dir, port_dir):
        shutil.copytree(os.path.join(png_root, "train"), out / "train")
    n = rx_run_png2jpeg(str(rx_dir), batch=50)
    assert port_tools.run_png2jpeg(str(port_dir), batch=37, nthreads=2, device="cpu") == n > 100
    for p in sorted(glob.glob(str(rx_dir / "**" / "*.jpeg"), recursive=True)):
        with open(p, "rb") as a, open(port_dir / os.path.relpath(p, rx_dir), "rb") as b:
            assert b.read() == a.read(), p
    stray = port_dir / "train" / "zz_stray.png"
    stray.write_bytes(cv2.imencode(".png", np.zeros((8, 9), np.uint8))[1].tobytes())
    with pytest.raises(SystemExit, match=r"zz_stray.png has size \(8, 9\), expected \(64, 64\)"):
        port_tools.run_png2jpeg(str(port_dir), device="cpu")
    stray.write_bytes(b"\x89PNG")
    with pytest.raises(SystemExit, match="png2jpeg: cannot read .*zz_stray.png"):
        port_tools.run_png2jpeg(str(port_dir), device="cpu")
    good = sorted(glob.glob(str(port_dir / "**" / "*.png"), recursive=True))[0]
    stray.write_bytes(open(good, "rb").read()[:-30])
    with pytest.raises(SystemExit, match="png2jpeg: cannot read .*zz_stray.png"):
        port_tools.main(["png2jpeg", "--data", str(port_dir), "--device", "cpu"])


def test_tools_stats_and_iobench_on_png(png_root, tmp_path, capsys):
    rx_run_stats(png_root, str(tmp_path / "rx.json"), ext="png", batch=50)
    port_tools.main(["stats", "--data", png_root, "--ext", "png", "--out",
                     str(tmp_path / "port.json"), "--batch", "50", "--device", "cpu"])
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "rx.json").read_bytes()
    want = rx_run_iobench(png_root, ext="png", batch=16, seconds=0.05)
    got = port_tools.run_iobench(png_root, ext="png", batch=16, nthreads=2, seconds=0.05,
                               device="cpu")
    assert set(want) <= set(got)
    assert got["image_size"] == SRC and got["threads"] == 2 and got["device"] == "cpu"
    assert got["train_views_per_s"] == port_tools.H100_TRAIN_VIEWS_PER_S == 395.9
    assert got["decode_images_per_s"] > 0
    assert got["views_per_s_supported"] == pytest.approx(got["decode_images_per_s"] / 6,
                                                         abs=0.1)
    port_tools.main(["iobench", "--data", png_root, "--ext", "png", "--batch", "8",
                     "--seconds", "0.01", "--train-views-per-s", "1e9", "--device", "cpu"])
    assert "'projected_decode_stall_pct': 100.0" in capsys.readouterr().out


def test_tools_pack_main_equals_rxtpus(png_root, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for flags in (["--compress", "zstd", "--compress-level", "2", "--filter", "png"],
                  ["--compress", "zlib"]):
        rx_tools_main(["pack", "--data", png_root, "--out", "rx", "--ext", "png"] + flags)
        port_tools.main(["pack", "--data", png_root, "--out", "port", "--ext", "png",
                         "--threads", "2", "--device", "cpu"] + flags)
        for name in ("train.rxpack", "train.rxpack.json", "test.rxpack", "test.rxpack.json"):
            assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "rx" / name
                                                               ).read_bytes(), (flags, name)


def test_write_png_tree_reads_back(tmp_path):
    fx = make_train_fixture(str(tmp_path / "fx"), nb_classes=4, n_experiments=1,
                            wells_per_experiment=4, n_test_wells=2, img_size=SRC)
    data = str(tmp_path / "data")
    n = write_png_tree(fx["pack_dir"], data, level=1, nthreads=2)
    paths = sorted(glob.glob(os.path.join(data, "*", "*", "*", "*.png")))
    assert n == len(paths) > 50
    for split in ("train", "test"):
        pack = PackStore(os.path.join(fx["pack_dir"], f"{split}.rxpack"))
        for key, ordinal in list(pack._entries.items())[:5]:
            exp, plate, well, site = key.split("|")
            view = np.asarray(pack._mm).reshape(-1, 6, SRC, SRC)[ordinal]
            for ch in range(6):
                path = os.path.join(data, split, exp, f"Plate{plate}",
                                    f"{well}_s{site}_w{ch + 1}.png")
                np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_GRAYSCALE),
                                              view[ch])
    np.testing.assert_array_equal(d.decode_files(paths, SRC, SRC, strict=True),
                                  rx.decode_files(paths, SRC, SRC, strict=True))


# ---- the slice: the CLI from a PNG tree and from a compressed pack ----------------

ARGV = ["--experiment_id", "png", "--nb-classes", "8", "--backbone", "resnet18",
        "--crop-size", "32", "--batch-size", "2", "--experiment-types", "0",
        "--image-ext", "png"]


def _f32(resolve):
    def patched(args):
        cfg = resolve(args)
        cfg.model.compute_dtype = "float32"
        return cfg
    return patched


@pytest.fixture(scope="module")
def png_slice_root(tmp_path_factory):
    """A plate-balanced PNG tree (cv2's files), a random rxtpu checkpoint as
    the run's best model, and rxtpu's f32 test-phase submission from its
    zlib+png pack of the tree (rxtpu computes the stats artifact)."""
    import jax

    from rxtpu.train.checkpoint import save_checkpoint
    from rxtpu.train.setup import build_model, create_train_state
    from test_torch_port_models import randomize_flax

    root = tmp_path_factory.mktemp("pngslice")
    make_plate_balanced_synthetic_dataset(str(root / "data"), nb_classes=8,
                                          n_train_experiments=3, n_test_experiments=1,
                                          test_types=(0,), img_size=48, ext="png")
    cwd = os.getcwd()
    os.chdir(root)
    mp = pytest.MonkeyPatch()
    try:
        rx_tools_main(["pack", "--data", "data", "--out", "packs", "--ext", "png",
                       "--splits", "test", "--compress", "zlib", "--filter", "png"])
        mp.setattr(rx_cli, "resolve_config", _f32(rx_cli.resolve_config))
        cfg = rx_cli.resolve_config(rx_cli.build_argparser().parse_args(ARGV))
        state, _ = create_train_state(cfg, build_model(cfg), steps_per_epoch=1)
        variables = randomize_flax({"params": jax.device_get(state.params),
                                    "batch_stats": jax.device_get(state.batch_stats)}, 0)
        os.makedirs("models")
        save_checkpoint(cfg.checkpoint_path, {"params": variables["params"],
                                              "batch_stats": variables["batch_stats"]})
        assert rx_cli.main(ARGV + ["--pack", "packs"]) == 0
        os.replace("stats_experiments.json", "rx_stats.json")
    finally:
        mp.undo()
        os.chdir(cwd)
    return root


def test_slice_png_submission_identical_to_rxtpu(png_slice_root, monkeypatch):
    """The port's CLI without ``--pack`` reads the PNG tree (its reader, the
    source size from a PNG header, the stats artifact computed from the tree
    and equal to rxtpu's), and with ``--pack`` the port's zlib+png pack of
    it; both write the submission rxtpu wrote from its own pack."""
    monkeypatch.chdir(png_slice_root)
    monkeypatch.setattr(port_cli, "resolve_config", _f32(port_cli.resolve_config))
    want = (png_slice_root / "submission_png.csv").read_bytes()
    assert len(want.splitlines()) == 9
    assert not os.path.exists("stats_experiments.json")
    os.makedirs("port_tree")
    assert port_cli.main(ARGV + ["--device", "cpu", "--out-dir", "port_tree"]) == 0
    assert (png_slice_root / "stats_experiments.json").read_bytes() == (
        png_slice_root / "rx_stats.json").read_bytes()
    assert (png_slice_root / "port_tree" / "submission_png.csv").read_bytes() == want
    port_tools.main(["pack", "--data", "data", "--out", "port_packs", "--ext", "png",
                     "--splits", "test", "--compress", "zlib", "--filter", "png",
                     "--device", "cpu"])
    assert (png_slice_root / "port_packs" / "test.rxpack").read_bytes() == (
        png_slice_root / "packs" / "test.rxpack").read_bytes()
    os.makedirs("port_pack")
    assert port_cli.main(ARGV + ["--pack", "port_packs", "--device", "cpu",
                                 "--out-dir", "port_pack"]) == 0
    assert (png_slice_root / "port_pack" / "submission_png.csv").read_bytes() == want


# ---- on the card ------------------------------------------------------------------

@pytest.mark.gpu
def test_png_and_mixed_batches_on_card_equal_cpu(png_root, synthetic_root):
    """PNG planes reach the card by a pinned copy; a mixed batch lands in one
    tensor, its JPEGs from nvJPEG (within one level of libjpeg), its PNGs bit
    for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the planes land on the card")
    pngs = sorted(glob.glob(os.path.join(png_root, "train", "*", "*", "*.png")))[:8]
    jpegs = sorted(glob.glob(os.path.join(synthetic_root[0], "train", "*", "*",
                                          "*.jpeg")))[:8]
    want = d.decode_files(pngs, SRC, SRC, strict=True)
    card = d.decode_files(pngs, SRC, SRC, nthreads=2, strict=True, device="cuda")
    bufs = d.decode_batch([open(p, "rb").read() for p in pngs], SRC, SRC, strict=True,
                          device="cuda")
    mixed = d.decode_files(pngs + jpegs, SRC, SRC, strict=True, device="cuda")
    torch.cuda.synchronize()
    assert card.is_cuda and mixed.is_cuda and mixed.shape == (16, SRC, SRC)
    np.testing.assert_array_equal(card.cpu().numpy(), want)
    np.testing.assert_array_equal(bufs.cpu().numpy(), want)
    np.testing.assert_array_equal(mixed[:8].cpu().numpy(), want)
    gap = np.abs(mixed[8:].cpu().numpy().astype(int)
                 - d.decode_files(jpegs, SRC, SRC, strict=True).astype(int))
    assert gap.max() <= 1


@pytest.mark.gpu
def test_png_pipeline_on_card_equals_cpu(png_root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pipeline's planes land on the card")
    _, index = _index_pair(png_root, "train")
    stats = _stats(sorted({r.experiment for r in index.records}))
    for preload in (True, False):
        store = ByteStore(index, png_root, ext="png", preload=preload)
        cpu = Pipeline(index, store, stats, 4, "train", seed=1, src_size=SRC)
        card = Pipeline(index, store, stats, 4, "train", seed=1, src_size=SRC,
                        device="cuda")
        for g, w in zip(card.epoch(0), cpu.epoch(0), strict=True):
            assert g["images"].is_cuda
            np.testing.assert_array_equal(g["images"].cpu().numpy(), w["images"])
