"""Batch JPEG decode and encode (counterpart of the JPEG half of
``rxtpu/data/decode.py``: ``decode_batch``, ``decode_files``,
``encode_batch_jpeg``; plus ``jpeg_size``, a header-only size probe).

Two routes, chosen by where the planes live:

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

Failed images decode to zeros and are counted; ``strict=True`` raises
instead. Departures from rxtpu: nothing falls back to cv2. A PNG buffer or
file raises ``NotImplementedError`` (PNG decode is not ported yet), and a
library that does not build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from rxtpu_torch.ops import _build

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
JPEG_EXTS = (".jpeg", ".jpg")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_contexts: Dict[Tuple[int, int], int] = {}  # (device index, threads) -> nvJPEG context
_contexts_lock = threading.Lock()


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
        raise ValueError(f"JPEG decode runs on the CPU or a CUDA device, not {device}")
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


def decode_batch(buffers: Sequence[bytes], height: int, width: int, nthreads: int = 0,
                 strict: bool = False, device="cpu") -> Union[np.ndarray, torch.Tensor]:
    """Decode grayscale JPEG buffers to uint8 [N, H, W]: a numpy array for
    ``device="cpu"``, a tensor on a CUDA device.

    Failed or mismatched images decode to zeros; ``strict=True`` raises
    instead (rxtpu's parity mode: the reference crashes on a corrupt file).
    ``nthreads <= 0`` uses every core.
    """
    device = _device(device)
    for i, b in enumerate(buffers):
        if b[:8] == PNG_MAGIC:
            raise NotImplementedError(f"buffer {i} is a PNG: PNG decode is not ported yet")
    n = len(buffers)
    data, offsets, lengths = _concat(buffers) if n else (None, None, None)
    if device.type == "cpu":
        out = np.empty((n, height, width), dtype=np.uint8)
        failures = n and _host_lib().rxtpu_decode_batch(
            data.ctypes.data, offsets.ctypes.data, lengths.ctypes.data, n, out.ctypes.data,
            height, width, nthreads)
    else:
        out = torch.empty((n, height, width), dtype=torch.uint8, device=device)
        failures = 0
        if n:
            ctx, threads = _nv_context(device, nthreads)
            failures = _nv_check(_nv_lib().rxtpu_nvjpeg_decode_batch(
                ctx, data.ctypes.data, offsets.ctypes.data, lengths.ctypes.data, n,
                out.data_ptr(), height, width, threads,
                torch.cuda.current_stream(device).cuda_stream), "decode_batch")
            decode_batch.launches += 1
    if strict and failures:
        raise ValueError(f"{failures}/{n} images failed to decode")
    return out


def decode_files(paths: Sequence[str], height: int, width: int, nthreads: int = 0,
                 strict: bool = False, device="cpu") -> Union[np.ndarray, torch.Tensor]:
    """Read and decode grayscale JPEG files to uint8 [N, H, W] (numpy on the
    CPU, a tensor on a CUDA device), the reads inside the native pool.

    Failed files decode to zeros; ``strict=True`` raises instead. A path that
    does not end in ``.jpeg`` or ``.jpg`` raises ``NotImplementedError``.
    """
    device = _device(device)
    for p in paths:
        if not p.endswith(JPEG_EXTS):
            kind = "PNG" if p.endswith(".png") else "non-JPEG"
            raise NotImplementedError(f"{p}: {kind} decode is not ported yet")
    n = len(paths)
    if device.type == "cpu":
        out = np.empty((n, height, width), dtype=np.uint8)
        failures = 0
        if n:
            blob, offsets = _path_blob(paths)
            failures = _host_lib().rxtpu_decode_files(
                blob, offsets.ctypes.data, n, out.ctypes.data, height, width, nthreads)
    else:
        out = torch.empty((n, height, width), dtype=torch.uint8, device=device)
        failures = 0
        if n:
            blob, offsets = _path_blob(paths)
            ctx, threads = _nv_context(device, nthreads)
            failures = _nv_check(_nv_lib().rxtpu_nvjpeg_decode_files(
                ctx, blob, offsets.ctypes.data, n, out.data_ptr(), height, width, threads,
                torch.cuda.current_stream(device).cuda_stream), "decode_files")
            decode_files.launches += 1
    if strict and failures:
        raise ValueError(f"{failures}/{n} files failed to read/decode")
    return out


def encode_batch_jpeg(planes: Union[np.ndarray, torch.Tensor], quality: int = 95,
                      nthreads: int = 0) -> List[bytes]:
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
        raise NotImplementedError(f"{path}: only JPEG headers are read (PNG is not ported yet)")
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


# launches on the card, counted by each wrapper where it calls nvJPEG
decode_batch.launches = 0
decode_files.launches = 0
encode_batch_jpeg.launches = 0
