"""Build the native sources under ``rxtpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``: no PyTorch headers, so a
build takes seconds. Each ``csrc/<name>.cpp`` is host code and compiles
with ``g++`` the same way (``jpeg_host.cpp``, libjpeg, the CPU's JPEG
decoder; ``inflate_host.cpp``, the PNG reader and the packs' codecs, which
binds zlib and zstd by ``dlopen``). Libraries go to ``rxtpu_torch/build/``
(git-ignored), named by a hash of the source and flags, so an edited source
rebuilds. ``build_all`` starts one compiler per source, all together; by
default it builds what the card's host needs: the CUDA sources and
``inflate_host.cpp`` (that host has no libjpeg for ``jpeg_host.cpp``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
HOST_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
# libraries a source links against, after the source on the command line
LINK = {"jpeg_host": ["-ljpeg", "-lpthread"], "jpeg_nv": ["-lnvjpeg"],
        "inflate_host": ["-ldl", "-lpthread"]}
CARD_HOST = ["inflate_host"]  # host sources that the card's machine builds too

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH, in $CUDA_HOME/bin and "
            "/usr/local/cuda/bin): the CUDA kernels cannot be built")
    return path


def _gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found on PATH: the host sources cannot be built")
    return found


def _source(name: str) -> Path:
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def _flags(name: str) -> List[str]:
    return NVCC_FLAGS if _source(name).suffix == ".cu" else HOST_FLAGS


def library_path(name: str) -> Path:
    flags = [*_flags(name), *LINK.get(name, [])]
    digest = hashlib.sha1(_source(name).read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"lib{name}.{digest.hexdigest()[:12]}.so"


def _start(name: str) -> Tuple[subprocess.Popen, Path, Path]:
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    src = _source(name)
    compiler = _nvcc() if src.suffix == ".cu" else _gxx()
    cmd = [compiler, *_flags(name), "-o", str(tmp), str(src), *LINK.get(name, [])]
    if src.suffix == ".cu" and name in LINK:
        # the toolkit's libraries (libnvjpeg) load from where nvcc found them
        lib_dir = Path(compiler).resolve().parent.parent / "lib64"
        cmd += ["-Xlinker", f"-rpath,{lib_dir}"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        src = _source(name).name
        raise RuntimeError(f"the build of csrc/{src} failed (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(log)
    return log


def build_all(names: List[str] = None) -> Dict[str, Tuple[float, str]]:
    """Build every source that has no library yet (by default every CUDA
    source and ``CARD_HOST``), one compiler each, all at once. Returns
    ``{name: (seconds, compiler output)}`` for the ones built."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu")) + CARD_HOST
    t0 = time.perf_counter()
    with _lock:
        started = {n: _start(n) for n in names if not library_path(n).exists()}
        results = {}
        try:
            for n, (proc, tmp, out) in started.items():
                log = _finish(n, proc, tmp, out)
                results[n] = (time.perf_counter() - t0, log)
        finally:
            for proc, _, _ in started.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return results


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` or ``.cpp``, built first if
    needed."""
    with _lock:
        lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return _loaded[name]
