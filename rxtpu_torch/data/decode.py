"""Batch image decode and encode, and the packs' codecs (counterpart of
``rxtpu/data/decode.py``: ``decode_batch``, ``decode_files``,
``encode_batch_jpeg``, ``inflate_batch``, ``deflate_filtered_batch``,
``inflate_unfilter_batch``, ``filter_plane_py``, ``unfilter_plane_py``; plus
the header probes ``jpeg_size``, ``png_size`` and ``image_size``).

JPEGs take one of two routes, chosen by where the planes live:

- on the CPU (``device="cpu"``; planes on the CPU to encode): the port's copy
  of rxtpu's libjpeg thread pool, ``csrc/jpeg_host.cpp``, built with ``g++
  -ljpeg`` at first use. Decoded planes are bit-equal to rxtpu's, encoded
  bytes byte-equal; the result is a numpy array, as in rxtpu.
- on a CUDA device: nvJPEG from the CUDA toolkit, ``csrc/jpeg_nv.cu``
  (the card's host has no libjpeg). Its pool of ``nthreads`` host threads
  runs the Huffman decode, the card the rest, and the planes land in a
  uint8 tensor on the device. nvJPEG's IDCT is not libjpeg's: planes may
  differ slightly from rxtpu's (``chip_smoke.py`` holds them to
  ``tests/data/jpeg_ref`` by a stated limit).

PNGs, and the compressed packs' zlib and zstd streams, are host work on
every device: ``csrc/inflate_host.cpp`` (the port's copy of rxtpu's
inflate, deflate and row-filter pool, plus a PNG reader), built with ``g++``
at first use, binds ``libz.so.1`` and ``libzstd.so.1`` by ``dlopen`` when a
codec is first asked for (``load_codec``); a host that lacks one raises and
names it. PNG planes for a CUDA device are read into pinned host memory and
reach the card by one copy on PyTorch's current stream. A batch that mixes
JPEGs and PNGs (routed per buffer by the JPEG magic, per path by the
extension, as rxtpu routes them) lands in one array or tensor.

Failed images decode to zeros and are counted; ``strict=True`` raises
instead. Departures from rxtpu, which reads every non-JPEG source with cv2:
nothing falls back to cv2 or to Python's ``zlib``. The PNG reader takes
8-bit grayscale, non-interlaced files (RxRx1's kind) and raises, even with
``strict=False``, on any other kind (colour, palette, 16-bit, interlaced),
which cv2 converts; it checks the CRC of every critical chunk. A path that
is neither ``.jpeg``/``.jpg`` nor ``.png`` raises. A library that does not
build raises with the compiler's output. ``filter_plane_py``,
``unfilter_plane_py`` and ``png_decode_py`` are plain versions for the
tests.
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct
import threading
import zlib
from typing import Callable, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from rxtpu_torch.ops import _build

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
JPEG_MAGIC = b"\xff\xd8"
JPEG_EXTS = (".jpeg", ".jpg")
CODECS = {"zlib": 0, "zstd": 1}
CODEC_LIBRARIES = {"zlib": "libz.so.1", "zstd": "libzstd.so.1"}
_PNG_UNSUPPORTED = 4  # csrc/inflate_host.cpp PngStatus kUnsupported

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_contexts: Dict[Tuple[int, int], int] = {}  # (device index, threads) -> nvJPEG context
_contexts_lock = threading.Lock()
Planes = Union[np.ndarray, torch.Tensor]


@functools.lru_cache(maxsize=None)
def _host_lib() -> ctypes.CDLL:
    lib = _build.load_library("jpeg_host")
    lib.rxtpu_decode_batch.argtypes = [_P, _P, _P, _I, _P, _I, _I, _I]
    lib.rxtpu_decode_files.argtypes = [ctypes.c_char_p, _P, _I, _P, _I, _I, _I]
    lib.rxtpu_encode_batch.argtypes = [_P, _I, _I, _I, _I, _P, _L, _P, _I]
    lib.rxtpu_jpeg_size.argtypes = [_P, _L, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    for fn in (lib.rxtpu_decode_batch, lib.rxtpu_decode_files, lib.rxtpu_encode_batch,
               lib.rxtpu_jpeg_size):
        fn.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _nv_lib() -> ctypes.CDLL:
    lib = _build.load_library("jpeg_nv")
    lib.rxtpu_nvjpeg_version.argtypes = [ctypes.POINTER(_I)] * 3
    lib.rxtpu_nvjpeg_create.argtypes = [_I, _I, ctypes.POINTER(_P)]
    lib.rxtpu_nvjpeg_decode_batch.argtypes = [_P, _P, _P, _P, _I, _P, _I, _I, _I, _P]
    lib.rxtpu_nvjpeg_decode_files.argtypes = [_P, ctypes.c_char_p, _P, _I, _P, _I, _I, _I,
                                              _P]
    lib.rxtpu_nvjpeg_encode_batch.argtypes = [_P, _P, _I, _I, _I, _I, _P, _L, _P, _P]
    lib.rxtpu_nvjpeg_size.argtypes = [_P, _P, _L, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    for fn in (lib.rxtpu_nvjpeg_version, lib.rxtpu_nvjpeg_create,
               lib.rxtpu_nvjpeg_decode_batch, lib.rxtpu_nvjpeg_decode_files,
               lib.rxtpu_nvjpeg_encode_batch, lib.rxtpu_nvjpeg_size):
        fn.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _inflate_lib() -> ctypes.CDLL:
    lib = _build.load_library("inflate_host")
    lib.rxtpu_codec_load.argtypes = [_I, ctypes.c_char_p, ctypes.c_char_p, _I]
    lib.rxtpu_inflate_batch.argtypes = [_P, _P, _P, _I, _P, _L, _I, _I]
    lib.rxtpu_deflate_filtered_batch.argtypes = [_P, _I, _L, _L, _L, _I, _I, _P, _L, _P, _I,
                                                 _I]
    lib.rxtpu_inflate_unfilter_batch.argtypes = [_P, _P, _P, _I, _P, _L, _L, _L, _I, _I]
    lib.rxtpu_png_decode_batch.argtypes = [_P, _P, _P, _I, _P, _I, _I, _I, _P]
    lib.rxtpu_png_decode_files.argtypes = [ctypes.c_char_p, _P, _I, _P, _I, _I, _I, _P]
    lib.rxtpu_png_size.argtypes = [_P, _L, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    lib.rxtpu_inflate_each.argtypes = [_P, _P, _I, _P, _P, _P, _I, _I]
    lib.rxtpu_compress_each.argtypes = [_P, _P, _I, _P, _P, _P, _I, _I, _I]
    for fn in (lib.rxtpu_codec_load, lib.rxtpu_inflate_batch,
               lib.rxtpu_deflate_filtered_batch, lib.rxtpu_inflate_unfilter_batch,
               lib.rxtpu_png_decode_batch, lib.rxtpu_png_decode_files, lib.rxtpu_png_size,
               lib.rxtpu_inflate_each, lib.rxtpu_compress_each):
        fn.restype = _I
    return lib


@functools.lru_cache(maxsize=None)  # a failure raises and is not cached
def load_codec(codec: str) -> Tuple[ctypes.CDLL, int]:
    """The host library with ``codec`` ("zlib" or "zstd") bound, and the
    codec's id. Binds ``libz.so.1`` or ``libzstd.so.1`` at first use; raises
    ``RuntimeError`` naming the library when this host cannot load it."""
    if codec not in CODECS:
        raise ValueError(f"unknown codec {codec!r} (want 'zlib' or 'zstd')")
    lib, cid = _inflate_lib(), CODECS[codec]
    err = ctypes.create_string_buffer(512)
    if lib.rxtpu_codec_load(cid, CODEC_LIBRARIES[codec].encode(), err, len(err)) != 0:
        raise RuntimeError(f"the {codec} codec needs {CODEC_LIBRARIES[codec]}, which this "
                           f"host cannot load: {err.value.decode(errors='replace')}")
    return lib, cid


def _nv_check(rc: int, what: str) -> int:
    """A count of failures passes; a negative code raises."""
    if rc >= 0:
        return rc
    code = -rc
    layer, value = ("nvJPEG status", code - 1000) if code < 2000 else ("CUDA error", code - 2000)
    raise RuntimeError(f"{what} failed on the card: {layer} {value}")


def nvjpeg_version() -> Tuple[int, int, int]:
    """nvJPEG's (major, minor, patch), read through the library."""
    v = [_I(), _I(), _I()]
    _nv_check(_nv_lib().rxtpu_nvjpeg_version(*(ctypes.byref(x) for x in v)), "nvjpeg_version")
    return tuple(x.value for x in v)


def _nv_context(device: torch.device, nthreads: int) -> Tuple[int, int]:
    """The nvJPEG context on ``device`` with ``nthreads`` decoders (all cores
    for ``nthreads <= 0``), created at first use; returns (context, threads)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    threads = nthreads if nthreads > 0 else (os.cpu_count() or 1)
    with _contexts_lock:
        ctx = _contexts.get((index, threads))
        if ctx is None:
            handle = _P()
            _nv_check(_nv_lib().rxtpu_nvjpeg_create(index, threads, ctypes.byref(handle)),
                      "nvJPEG context")
            ctx = _contexts[(index, threads)] = handle.value
    return ctx, threads


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"image decode runs on the CPU or a CUDA device, not {device}")
    return device


def _concat(buffers: Sequence[bytes]):
    lengths = np.array([len(b) for b in buffers], dtype=np.int64)
    offsets = np.zeros(len(buffers), dtype=np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    return np.frombuffer(b"".join(buffers), dtype=np.uint8), offsets, lengths


def _path_blob(paths: Sequence[str]):
    encoded = [p.encode() + b"\0" for p in paths]
    offsets = np.zeros(len(paths), dtype=np.int64)
    np.cumsum([len(p) for p in encoded[:-1]], out=offsets[1:])
    return b"".join(encoded), offsets


# ---- JPEG ------------------------------------------------------------------

def _jpeg_buffers(buffers: Sequence[bytes], height: int, width: int, nthreads: int,
                  device: torch.device) -> Tuple[Planes, int]:
    n = len(buffers)
    data, offsets, lengths = _concat(buffers) if n else (None, None, None)
    if device.type == "cpu":
        out = np.empty((n, height, width), dtype=np.uint8)
        failures = n and _host_lib().rxtpu_decode_batch(
            data.ctypes.data, offsets.ctypes.data, lengths.ctypes.data, n, out.ctypes.data,
            height, width, nthreads)
        return out, failures
    out = torch.empty((n, height, width), dtype=torch.uint8, device=device)
    failures = 0
    if n:
        ctx, threads = _nv_context(device, nthreads)
        failures = _nv_check(_nv_lib().rxtpu_nvjpeg_decode_batch(
            ctx, data.ctypes.data, offsets.ctypes.data, lengths.ctypes.data, n,
            out.data_ptr(), height, width, threads,
            torch.cuda.current_stream(device).cuda_stream), "decode_batch")
        decode_batch.launches += 1
    return out, failures


def _jpeg_files(paths: Sequence[str], height: int, width: int, nthreads: int,
                device: torch.device) -> Tuple[Planes, int]:
    n = len(paths)
    blob, offsets = _path_blob(paths) if n else (None, None)
    if device.type == "cpu":
        out = np.empty((n, height, width), dtype=np.uint8)
        failures = n and _host_lib().rxtpu_decode_files(
            blob, offsets.ctypes.data, n, out.ctypes.data, height, width, nthreads)
        return out, failures
    out = torch.empty((n, height, width), dtype=torch.uint8, device=device)
    failures = 0
    if n:
        ctx, threads = _nv_context(device, nthreads)
        failures = _nv_check(_nv_lib().rxtpu_nvjpeg_decode_files(
            ctx, blob, offsets.ctypes.data, n, out.data_ptr(), height, width, threads,
            torch.cuda.current_stream(device).cuda_stream), "decode_files")
        decode_files.launches += 1
    return out, failures


# ---- PNG -------------------------------------------------------------------

def _ihdr_text(head: bytes) -> str:
    """The kind of PNG that an IHDR (a file's first 33 bytes) declares."""
    if len(head) < 29 or head[:8] != PNG_MAGIC or head[12:16] != b"IHDR":
        return "no IHDR"
    depth, colour, interlace = head[24], head[25], head[28]
    return (f"bit depth {depth}, colour type {colour}"
            + (", interlaced" if interlace else ", not interlaced"))


def _png_run(call: Callable[[int, int], int], n: int, height: int, width: int,
             device: torch.device, describe: Callable[[int], str]) -> Tuple[Planes, int]:
    """Run a native PNG batch ``call(out pointer, status pointer)`` into host
    planes (pinned for a CUDA device, then one copy there on the current
    stream). Raises on an unsupported PNG; returns (planes, failures)."""
    status = np.zeros(n, np.int32)
    if device.type == "cuda":
        host = torch.empty((n, height, width), dtype=torch.uint8, pin_memory=True)
        ptr = host.data_ptr()
    else:
        host = np.empty((n, height, width), dtype=np.uint8)
        ptr = host.ctypes.data
    failures = call(ptr, status.ctypes.data) if n else 0
    unsupported = np.flatnonzero(status == _PNG_UNSUPPORTED)
    if unsupported.size:
        raise ValueError(
            f"{describe(int(unsupported[0]))}: the port reads 8-bit grayscale PNGs without "
            "interlace only (RxRx1's kind; cv2, which rxtpu reads PNGs with, converts other "
            f"kinds); {unsupported.size}/{n} PNGs of this batch are of another kind")
    if device.type == "cuda":
        return host.to(device, non_blocking=True), failures
    return host, failures


def _png_buffers(buffers: Sequence[bytes], height: int, width: int, nthreads: int,
                 device: torch.device) -> Tuple[Planes, int]:
    lib, _ = load_codec("zlib")
    data, offsets, lengths = _concat(buffers) if buffers else (None, None, None)
    return _png_run(
        lambda out, status: lib.rxtpu_png_decode_batch(
            data.ctypes.data, offsets.ctypes.data, lengths.ctypes.data, len(buffers), out,
            height, width, nthreads, status),
        len(buffers), height, width, device,
        lambda i: f"buffer {i} ({_ihdr_text(buffers[i][:33])})")


def _png_files(paths: Sequence[str], height: int, width: int, nthreads: int,
               device: torch.device) -> Tuple[Planes, int]:
    lib, _ = load_codec("zlib")
    blob, offsets = _path_blob(paths) if paths else (None, None)

    def describe(i):
        with open(paths[i], "rb") as f:
            return f"{paths[i]} ({_ihdr_text(f.read(33))})"

    return _png_run(
        lambda out, status: lib.rxtpu_png_decode_files(
            blob, offsets.ctypes.data, len(paths), out, height, width, nthreads, status),
        len(paths), height, width, device, describe)


def _routed(items: Sequence, is_jpeg: Sequence[bool], jpeg_fn, png_fn, height: int,
            width: int, device: torch.device) -> Tuple[Planes, int]:
    """Decode each item through its route; a mixed batch lands in one array
    (CPU) or one tensor (CUDA device: the JPEG planes from nvJPEG, which has
    returned when they are written, and the PNG planes' copy are gathered on
    the current stream)."""
    jp = [i for i, m in enumerate(is_jpeg) if m]
    other = [i for i, m in enumerate(is_jpeg) if not m]
    if not other or not jp:
        return (png_fn if other else jpeg_fn)(items)
    sub_j, f_j = jpeg_fn([items[i] for i in jp])
    sub_p, f_p = png_fn([items[i] for i in other])
    n = len(items)
    if device.type == "cpu":
        out = np.empty((n, height, width), dtype=np.uint8)
    else:
        out = torch.empty((n, height, width), dtype=torch.uint8, device=device)
    out[jp] = sub_j
    out[other] = sub_p
    return out, f_j + f_p


def decode_batch(buffers: Sequence[bytes], height: int, width: int, nthreads: int = 0,
                 strict: bool = False, device="cpu") -> Planes:
    """Decode grayscale JPEG and PNG buffers to uint8 [N, H, W]: a numpy array
    for ``device="cpu"``, a tensor on a CUDA device.

    A buffer that starts with the JPEG magic goes to the JPEG decoder, any
    other to the PNG reader. Failed or mismatched images decode to zeros;
    ``strict=True`` raises instead (rxtpu's parity mode: the reference
    crashes on a corrupt file). An unsupported kind of PNG raises either way.
    ``nthreads <= 0`` uses every core.
    """
    device = _device(device)
    planes, failures = _routed(
        buffers, [b[:2] == JPEG_MAGIC for b in buffers],
        lambda b: _jpeg_buffers(b, height, width, nthreads, device),
        lambda b: _png_buffers(b, height, width, nthreads, device), height, width, device)
    if strict and failures:
        raise ValueError(f"{failures}/{len(buffers)} images failed to decode")
    return planes


def decode_files(paths: Sequence[str], height: int, width: int, nthreads: int = 0,
                 strict: bool = False, device="cpu") -> Planes:
    """Read and decode grayscale JPEG (``.jpeg``, ``.jpg``) and PNG (``.png``)
    files to uint8 [N, H, W] (numpy on the CPU, a tensor on a CUDA device),
    the reads inside the native pools.

    Failed files decode to zeros; ``strict=True`` raises instead. Another
    extension, or an unsupported kind of PNG, raises.
    """
    device = _device(device)
    for p in paths:
        if not p.endswith(JPEG_EXTS + (".png",)):
            raise ValueError(f"{p}: only JPEG (.jpeg, .jpg) and PNG (.png) files are read")
    planes, failures = _routed(
        paths, [p.endswith(JPEG_EXTS) for p in paths],
        lambda p: _jpeg_files(p, height, width, nthreads, device),
        lambda p: _png_files(p, height, width, nthreads, device), height, width, device)
    if strict and failures:
        raise ValueError(f"{failures}/{len(paths)} files failed to read/decode")
    return planes


def encode_batch_jpeg(planes: Planes, quality: int = 95, nthreads: int = 0) -> List[bytes]:
    """Encode uint8 [N, H, W] planes to grayscale JPEG buffers (quality 95, as
    rxtpu's ``png2jpeg``): with libjpeg for planes on the CPU (numpy or a CPU
    tensor; rxtpu's bytes), with nvJPEG for a tensor on a CUDA device.

    Raises on any failed encode: an empty buffer written as a 0-byte file
    would poison later runs. Each slot holds twice a raw plane, so a JPEG
    larger than its raw plane (random noise) still fits.
    """
    n, h, w = planes.shape
    cap = 2 * h * w + 4096
    out = np.empty((n, cap), dtype=np.uint8)
    out_lengths = np.zeros(n, dtype=np.int64)
    if isinstance(planes, torch.Tensor) and planes.is_cuda:
        if planes.dtype != torch.uint8:
            raise ValueError(f"planes must be uint8, got {planes.dtype}")
        planes = planes.contiguous()
        ctx, _ = _nv_context(planes.device, 1)
        failures = n and _nv_check(_nv_lib().rxtpu_nvjpeg_encode_batch(
            ctx, planes.data_ptr(), n, h, w, quality, out.ctypes.data, cap,
            out_lengths.ctypes.data, torch.cuda.current_stream(planes.device).cuda_stream),
            "encode_batch_jpeg")
        encode_batch_jpeg.launches += 1
    else:
        planes = np.ascontiguousarray(planes, dtype=np.uint8)
        failures = n and _host_lib().rxtpu_encode_batch(
            planes.ctypes.data, n, h, w, quality, out.ctypes.data, cap,
            out_lengths.ctypes.data, nthreads)
    if failures:
        raise ValueError(f"{failures}/{n} planes failed to encode")
    return [out[i, : out_lengths[i]].tobytes() for i in range(n)]


def jpeg_size(path: str, device="cpu") -> Tuple[int, int]:
    """(height, width) of a JPEG file from its header alone: libjpeg's
    ``jpeg_read_header`` on the CPU, nvJPEG's header parse for a CUDA device
    (host work on both)."""
    device = _device(device)
    if not path.endswith(JPEG_EXTS):
        raise NotImplementedError(f"{path}: jpeg_size reads JPEG headers only "
                                  "(image_size reads PNG ones too)")
    with open(path, "rb") as f:
        data = f.read()
    arr = np.frombuffer(data, dtype=np.uint8)
    h, w = _I(), _I()
    if device.type == "cpu":
        rc = _host_lib().rxtpu_jpeg_size(arr.ctypes.data, len(data), ctypes.byref(h),
                                         ctypes.byref(w))
    else:
        ctx, _ = _nv_context(device, 1)
        rc = _nv_lib().rxtpu_nvjpeg_size(ctx, arr.ctypes.data, len(data), ctypes.byref(h),
                                         ctypes.byref(w))
    if rc != 0:
        raise ValueError(f"{path}: not a readable JPEG header (code {rc})")
    return h.value, w.value


def png_size(path: str) -> Tuple[int, int]:
    """(height, width) of a PNG file from its IHDR alone (its first 33
    bytes, CRC checked)."""
    lib, _ = load_codec("zlib")
    with open(path, "rb") as f:
        head = f.read(33)
    arr = np.frombuffer(head, dtype=np.uint8)
    h, w = _I(), _I()
    rc = lib.rxtpu_png_size(arr.ctypes.data, len(head), ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise ValueError(f"{path}: not a readable PNG header (code {rc})")
    return h.value, w.value


def image_size(path: str, device="cpu") -> Tuple[int, int]:
    """(height, width) of a ``.png`` file by ``png_size``, else of a JPEG by
    ``jpeg_size`` on ``device``."""
    return png_size(path) if path.endswith(".png") else jpeg_size(path, device)


# ---- compressed packs: zlib and zstd streams, with or without the row filter

def _streams(data: np.ndarray, offsets, lengths):
    """``data`` as a contiguous uint8 array (a memmap stays a view: no copy
    of the pack), ``offsets`` and ``lengths`` as int64, every stream inside
    ``data``."""
    data = np.ascontiguousarray(data)
    if data.dtype != np.uint8:
        raise ValueError(f"stream data must be uint8, got {data.dtype}")
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    if offsets.shape != lengths.shape or offsets.ndim != 1:
        raise ValueError("offsets and lengths must be two 1-d arrays of one length")
    if len(offsets) and (offsets.min() < 0 or lengths.min() < 0
                         or (offsets + lengths).max() > data.size):
        raise ValueError(f"a stream lies outside the {data.size}-byte buffer")
    return data, offsets, lengths


def inflate_batch(data: np.ndarray, offsets, lengths, item_bytes: int, nthreads: int = 0,
                  strict: bool = False, codec: str = "zlib") -> np.ndarray:
    """Decompress N zlib/zstd streams out of one contiguous uint8 buffer
    (typically a pack's memmap, read lazily by the pool's threads) to uint8
    [N, item_bytes]. Every stream must inflate to exactly ``item_bytes``;
    failures zero-fill, or raise with ``strict=True``."""
    lib, cid = load_codec(codec)
    data, offsets, lengths = _streams(data, offsets, lengths)
    n = len(offsets)
    out = np.empty((n, item_bytes), dtype=np.uint8)
    failures = n and lib.rxtpu_inflate_batch(
        data.ctypes.data, offsets.ctypes.data, lengths.ctypes.data, n, out.ctypes.data,
        item_bytes, cid, nthreads)
    if strict and failures:
        raise ValueError(f"{failures}/{n} records failed to decompress")
    return out


def deflate_filtered_batch(views: np.ndarray, level: int = 6, use_filter: bool = True,
                           nthreads: int = 0, codec: str = "zlib") -> List[bytes]:
    """Row-filter (optionally, each plane by the PNG filters) and compress
    uint8 views [N, C, H, W]: one zlib/zstd stream per view, filter and codec
    inside the pool. Raises on any failed compress (a truncated stream in a
    pack would poison every later read). ``level`` follows the codec's scale
    (zlib 1-9, zstd 1-22)."""
    lib, cid = load_codec(codec)
    n, c, h, w = views.shape
    views = np.ascontiguousarray(views, dtype=np.uint8)
    src_bytes = c * h * (w + 1) if use_filter else c * h * w
    cap = src_bytes + src_bytes // 128 + 1024  # above both codecs' compress bounds
    out = np.empty((n, cap), np.uint8)
    out_lengths = np.zeros(n, np.int64)
    failures = n and lib.rxtpu_deflate_filtered_batch(
        views.ctypes.data, n, c, h, w, level, int(use_filter), out.ctypes.data, cap,
        out_lengths.ctypes.data, cid, nthreads)
    if failures:
        raise ValueError(f"{failures}/{n} views failed to compress")
    return [out[i, : out_lengths[i]].tobytes() for i in range(n)]


def inflate_unfilter_batch(data: np.ndarray, offsets, lengths, c: int, h: int, w: int,
                           nthreads: int = 0, strict: bool = False,
                           codec: str = "zlib") -> np.ndarray:
    """Inflate and unfilter N row-filtered streams to uint8 [N, C, H, W]: the
    read side of the "png"-filtered pack, with ``inflate_batch``'s contract."""
    lib, cid = load_codec(codec)
    data, offsets, lengths = _streams(data, offsets, lengths)
    n = len(offsets)
    out = np.empty((n, c, h, w), dtype=np.uint8)
    failures = n and lib.rxtpu_inflate_unfilter_batch(
        data.ctypes.data, offsets.ctypes.data, lengths.ctypes.data, n, out.ctypes.data,
        c, h, w, cid, nthreads)
    if strict and failures:
        raise ValueError(f"{failures}/{n} records failed to decompress")
    return out


def _addresses(arrays: Sequence[np.ndarray]) -> np.ndarray:
    return np.array([a.ctypes.data for a in arrays], dtype=np.uintp)


def inflate_each(streams: Sequence, sizes: Sequence[int], nthreads: int = 0,
                 exact: bool = True) -> List[np.ndarray]:
    """Decompress zstd streams of any sizes (bytes-like each) to uint8
    arrays, in the pool. Each must come to exactly its ``sizes`` bytes; with
    ``exact=False`` the sizes are capacities and each array is cut to its
    stream's size. Raises if a stream is corrupt or does not fit."""
    lib, cid = load_codec("zstd")
    src = [np.frombuffer(b, dtype=np.uint8) for b in streams]
    out = [np.empty(int(n), dtype=np.uint8) for n in sizes]
    if len(src) != len(out):
        raise ValueError(f"{len(src)} streams for {len(out)} sizes")
    if not src:
        return out
    src_lengths = np.array([a.size for a in src], dtype=np.int64)
    caps = np.array([a.size for a in out], dtype=np.int64)
    got = np.zeros(len(src), dtype=np.int64)
    src_at, out_at = _addresses(src), _addresses(out)  # held alive across the call
    failures = lib.rxtpu_inflate_each(src_at.ctypes.data, src_lengths.ctypes.data, len(src),
                                      out_at.ctypes.data, caps.ctypes.data, got.ctypes.data,
                                      cid, nthreads)
    short = int((got != caps).sum()) if exact else 0
    if failures or short:
        raise ValueError(f"{max(failures, short)}/{len(src)} zstd streams failed to "
                         "decompress " + ("to their sizes" if exact else "within their caps"))
    return out if exact else [a[:n] for a, n in zip(out, got)]


def compress_each(buffers: Sequence, level: int = 1, nthreads: int = 0) -> List[bytes]:
    """Compress buffers of any sizes (bytes-like, or arrays read as their
    bytes in C order) with zstd at ``level``, one stream each, in the pool;
    raises on any failed compress."""
    lib, cid = load_codec("zstd")
    src = [np.frombuffer(b, dtype=np.uint8) if not isinstance(b, np.ndarray)
           else np.ascontiguousarray(b.reshape(-1)).view(np.uint8) for b in buffers]
    if not src:
        return []
    src_lengths = np.array([a.size for a in src], dtype=np.int64)
    caps = src_lengths + src_lengths // 128 + 1024  # above zstd's compress bound
    out = [np.empty(int(c), dtype=np.uint8) for c in caps]
    out_lengths = np.zeros(len(src), dtype=np.int64)
    src_at, out_at = _addresses(src), _addresses(out)  # held alive across the call
    failures = lib.rxtpu_compress_each(src_at.ctypes.data, src_lengths.ctypes.data, len(src),
                                       out_at.ctypes.data, caps.ctypes.data,
                                       out_lengths.ctypes.data, level, cid, nthreads)
    if failures:
        raise ValueError(f"{failures}/{len(src)} buffers failed to compress")
    return [o[:n].tobytes() for o, n in zip(out, out_lengths)]


# ---- plain versions, for the tests -------------------------------------------

def filter_plane_py(plane: np.ndarray) -> np.ndarray:
    """uint8 [H, W] -> filtered uint8 [H, W+1] (filter id + residual row), the
    per-row least sum of absolute residuals over none/sub/up/avg/paeth."""
    h, w = plane.shape
    p = plane.astype(np.int32)
    left = np.zeros_like(p)
    left[:, 1:] = p[:, :-1]
    up = np.zeros_like(p)
    up[1:, :] = p[:-1, :]
    upleft = np.zeros_like(p)
    upleft[1:, 1:] = p[:-1, :-1]
    pa = np.abs(up - upleft)
    pb = np.abs(left - upleft)
    pc = np.abs(left + up - 2 * upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    cand = np.stack([p, p - left, p - up, p - ((left + up) >> 1), p - paeth]).astype(np.uint8)
    cost = np.abs(cand.astype(np.int8).astype(np.int32)).sum(axis=2)  # [5, H]
    choice = cost.argmin(axis=0)
    out = np.empty((h, w + 1), np.uint8)
    out[:, 0] = choice
    out[:, 1:] = cand[choice, np.arange(h)]
    return out


def unfilter_plane_py(filt: np.ndarray) -> np.ndarray:
    """Inverse of ``filter_plane_py``: uint8 [H, W+1] -> [H, W]. Raises
    ``ValueError`` on a filter id above 4."""
    h, w = filt.shape[0], filt.shape[1] - 1
    out = np.empty((h, w), np.uint8)
    for y in range(h):
        ft = int(filt[y, 0])
        row = filt[y, 1:].astype(np.int32)
        above = out[y - 1].astype(np.int32) if y else np.zeros(w, np.int32)
        if ft == 0:
            cur = row
        elif ft == 1:  # sub: a running mod-256 sum
            cur = np.cumsum(row) & 0xFF
        elif ft == 2:
            cur = (row + above) & 0xFF
        elif ft in (3, 4):  # avg and paeth carry the left neighbour
            cur = np.empty(w, np.int32)
            a = c = 0
            for x in range(w):
                b = int(above[x])
                if ft == 3:
                    a = (int(row[x]) + ((a + b) >> 1)) & 0xFF
                else:
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                    a = (int(row[x]) + pred) & 0xFF
                    c = b
                cur[x] = a
        else:
            raise ValueError(f"corrupt filter id {ft} at row {y}")
        out[y] = cur
    return out


def png_decode_py(buf: bytes) -> np.ndarray:
    """Plain PNG reader: the chunks with each critical chunk's CRC
    (``zlib.crc32``), IHDR (8-bit gray, no interlace), the IDAT data joined
    through ``zlib.decompress`` and ``unfilter_plane_py``. uint8 [H, W];
    raises ``ValueError`` on anything else."""
    if buf[:8] != PNG_MAGIC:
        raise ValueError("not a PNG signature")
    pos, idat, size = 8, [], None
    while True:
        if pos + 12 > len(buf):
            raise ValueError("truncated PNG: no IEND")
        (clen,) = struct.unpack(">I", buf[pos:pos + 4])
        kind, data = buf[pos + 4:pos + 8], buf[pos + 8:pos + 8 + clen]
        if pos + 12 + clen > len(buf):
            raise ValueError(f"truncated {kind!r} chunk")
        critical = not kind[0] & 0x20
        if critical and zlib.crc32(kind + data) != struct.unpack(
                ">I", buf[pos + 8 + clen:pos + 12 + clen])[0]:
            raise ValueError(f"bad CRC in the {kind!r} chunk")
        pos += 12 + clen
        if size is None:
            if kind != b"IHDR" or clen != 13:
                raise ValueError("the first chunk is not IHDR")
            w, h, depth, colour, method, filt, interlace = struct.unpack(">IIBBBBB", data)
            if (depth, colour, interlace, method, filt) != (8, 0, 0, 0, 0):
                raise ValueError(f"unsupported PNG: {_ihdr_text(buf[:33])}")
            size = (h, w)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
        elif critical:
            raise ValueError(f"unexpected critical chunk {kind!r}")
    h, w = size
    try:
        rows = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"IDAT does not inflate: {e}") from e
    if len(rows) != h * (w + 1):
        raise ValueError(f"IDAT inflates to {len(rows)} bytes, not {h * (w + 1)}")
    return unfilter_plane_py(np.frombuffer(rows, np.uint8).reshape(h, w + 1))


# launches on the card, counted by each wrapper where it calls nvJPEG
decode_batch.launches = 0
decode_files.launches = 0
encode_batch_jpeg.launches = 0
