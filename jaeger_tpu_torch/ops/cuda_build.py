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
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "jaeger_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

#: loaded libraries by source name, the seconds each build took and what
#: nvcc printed
_LIBS: dict[str, ctypes.CDLL] = {}
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


def _digest(name: str, flags: tuple[str, ...]) -> str:
    """Hash of ``csrc/<name>.cu``, every ``csrc/*.cuh`` it may include, and
    the nvcc flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(b"\0" + header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(flags).encode())
    return h.hexdigest()[:16]


def load(name: str, extra_flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and return the loaded library.

    ``extra_flags`` go to nvcc after the standard ones (for example
    ``("-Xptxas", "-v")`` to print register and shared-memory use); the
    compiler's output is printed when it is non-empty.
    """
    if name in _LIBS:
        return _LIBS[name]
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
        build_seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
        build_logs[name] = proc.stdout + proc.stderr
        if build_logs[name].strip():
            print(build_logs[name], end="", flush=True)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    _LIBS[name] = lib
    return lib
