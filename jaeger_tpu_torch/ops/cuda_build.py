"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use, for ``sm_90a`` (Hopper), into
``<repo>/build/jaeger_tpu_torch/<name>-<hash>.so``; the hash covers the
source, every header in ``csrc/`` and the flags, so an edited source or
header never loads a stale library.
Nothing is built when a module is imported, only when a kernel is first
launched on a CUDA tensor.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "jaeger_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

#: nvcc flags that change only what it prints, not the library
PRINT_FLAGS = (("-Xptxas", "-v"),)

#: loaded libraries by :func:`_key` (the source name, then any ``-D``
#: flags), the seconds each build took and what nvcc printed
_LIBS: dict[str, ctypes.CDLL] = {}
#: one lock per key, so threads that load one library build it once
_LOCKS: dict[str, threading.Lock] = {}
_LOCKS_GUARD = threading.Lock()
build_seconds: dict[str, float] = {}
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc"]:
        if Path(cand).is_file():
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _code_flags(flags: tuple[str, ...]) -> tuple[str, ...]:
    """``flags`` without the pairs of :data:`PRINT_FLAGS`."""
    out, i = [], 0
    while i < len(flags):
        if tuple(flags[i:i + 2]) in PRINT_FLAGS:
            i += 2
            continue
        out.append(flags[i])
        i += 1
    return tuple(out)


def _digest(name: str, flags: tuple[str, ...]) -> str:
    """Hash of ``csrc/<name>.cu``, every ``csrc/*.cuh`` it may include, and
    the nvcc flags that change the library (a build with ``-Xptxas -v``
    writes the file every other process then loads)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(b"\0" + header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(_code_flags(flags)).encode())
    return h.hexdigest()[:16]


def _key(name: str, flags: tuple[str, ...]) -> str:
    """A library's key: its source name and the ``-D`` flags among
    ``flags``, the ones that change its code (a build with ``-Xptxas -v``,
    which only changes what nvcc prints, is the library of its name)."""
    return " ".join([name, *(f for f in flags if f.startswith("-D"))])


def load(name: str, extra_flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and return the loaded library.

    ``extra_flags`` go to nvcc after the standard ones (for example
    ``("-Xptxas", "-v")`` to print register and shared-memory use); the
    compiler's output is printed when it is non-empty. The first load of a
    name and ``-D`` flags is the library every later load of them returns
    (:func:`_key`); threads that load it at once wait for one build.
    """
    key = _key(name, tuple(extra_flags))
    with _LOCKS_GUARD:
        lock = _LOCKS.setdefault(key, threading.Lock())
    with lock:
        return _LIBS.get(key) or _build(name, key, tuple(extra_flags))


def _build(name: str, key: str, extra_flags: tuple[str, ...]) -> ctypes.CDLL:
    """Build and load ``csrc/<name>.cu`` under ``key`` (see :func:`load`)."""
    src = CSRC / f"{name}.cu"
    flags = NVCC_FLAGS + tuple(extra_flags)
    lib_path = BUILD_DIR / f"{name}-{_digest(name, flags)}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *flags, "-o", str(tmp), str(src)],
            capture_output=True, text=True)
        build_seconds[key] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
        build_logs[key] = proc.stdout + proc.stderr
        if build_logs[key].strip():
            print(build_logs[key], end="", flush=True)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    _LIBS[key] = lib
    return lib
