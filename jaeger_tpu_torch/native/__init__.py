"""Copy of `jaeger_tpu/native/__init__.py`: ctypes bindings for the port's
native host library.

Builds ``libjaeger_host-<hash>.so`` from :file:`jaeger_host.cpp` on first
use (g++ -O3 -march=native, linked with zlib) into
``<repo>/build/jaeger_tpu_torch/``, or into the user cache
(``$XDG_CACHE_HOME/jaeger_tpu_torch``) when that directory cannot be
written; the hash covers the source and the flags. It exposes the native
FASTA reader, SDUST masker, encoder, window pipeline and Smith-Waterman.
Every entry point has a pure-Python fallback elsewhere in the package;
:func:`available` says whether the native path is live, and
``JAEGER_TPU_TORCH_NATIVE=0`` forces the Python path. The JAX package's
library (``jaeger_tpu/native/libjaeger_host.so``) is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

logger = logging.getLogger("jaeger_tpu_torch")

_SRC = Path(__file__).parent / "jaeger_host.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "jaeger_tpu_torch"
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
ENV_SWITCH = "JAEGER_TPU_TORCH_NATIVE"

_LIB: ctypes.CDLL | None = None
_LIB_PATH: Path | None = None
_TRIED = False
_LOCK = threading.Lock()


def _lib_name() -> str:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update("\0".join(GXX_FLAGS + ("-lz",)).encode())
    return f"libjaeger_host-{h.hexdigest()[:16]}.so"


def _cache_so() -> Path:
    """Per-user fallback build location for read-only installs."""
    root = Path(os.environ.get("XDG_CACHE_HOME",
                               Path.home() / ".cache")) / "jaeger_tpu_torch"
    return root / _lib_name()


def _build(target: Path) -> str | None:
    """Compile into ``target`` (through a per-process temporary file and
    ``os.replace``, so parallel builders never load a half-written
    library). Returns None on success, else the reason."""
    try:
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp), "-lz"]
        result = subprocess.run(cmd, capture_output=True, text=True,
                                timeout=300)
        if result.returncode != 0:
            tmp.unlink(missing_ok=True)
            return f"g++ failed: {result.stderr.strip()[:500]}"
        os.replace(tmp, target)
        return None
    except (OSError, subprocess.SubprocessError) as e:
        return f"cannot build: {e}"


def _bind(lib: ctypes.CDLL) -> None:
    lib.jt_open_fasta.restype = ctypes.c_void_p
    lib.jt_open_fasta.argtypes = [ctypes.c_char_p]
    lib.jt_next_contig.restype = ctypes.c_long
    lib.jt_next_contig.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_char_p),
    ]
    lib.jt_close_fasta.argtypes = [ctypes.c_void_p]
    lib.jt_fasta_error.restype = ctypes.c_char_p
    lib.jt_fasta_error.argtypes = [ctypes.c_void_p]
    lib.jt_encode_ascii.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p,
    ]
    lib.jt_composition.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_long),
    ]
    lib.jt_sdust.restype = ctypes.c_long
    lib.jt_sdust.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_long), ctypes.c_long,
    ]
    lib.jt_dust_mask.restype = ctypes.c_long
    lib.jt_dust_mask.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
    ]
    lib.jt_contig_ids.restype = ctypes.c_long
    lib.jt_contig_ids.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p,
    ]
    lib.jt_window_counts.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_long), ctypes.c_long,
        ctypes.c_long, ctypes.POINTER(ctypes.c_long),
    ]
    lib.jt_contig_rows.restype = ctypes.c_long
    lib.jt_contig_rows.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_long), ctypes.c_long,
        ctypes.c_long, ctypes.c_long, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.jt_pipeline_open.restype = ctypes.c_void_p
    lib.jt_pipeline_open.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
        ctypes.c_double, ctypes.c_long, ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_long, ctypes.c_int,
    ]
    lib.jt_pipeline_next.restype = ctypes.c_long
    lib.jt_pipeline_next.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.jt_pipeline_header_bytes.restype = ctypes.c_long
    lib.jt_pipeline_header_bytes.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
    ]
    lib.jt_pipeline_drain_headers.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
    ]
    lib.jt_pipeline_error.restype = ctypes.c_char_p
    lib.jt_pipeline_error.argtypes = [ctypes.c_void_p]
    lib.jt_pipeline_close.argtypes = [ctypes.c_void_p]
    lib.jt_smith_waterman.restype = ctypes.c_long
    lib.jt_smith_waterman.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long,
    ]


def _load() -> ctypes.CDLL | None:
    """Build (once per source and flags) and load the library; on failure
    warn with the reason and return None, so callers take the Python
    path."""
    global _LIB, _LIB_PATH, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        so = BUILD_DIR / _lib_name()
        reason = None
        if not so.exists():
            reason = _build(so)
            if reason is not None:
                # read-only checkout: retry in the user cache
                so = _cache_so()
                if not so.exists():
                    cache_reason = _build(so)
                    if cache_reason is not None:
                        logger.warning(
                            "native host library unavailable (%s; user "
                            "cache: %s): FASTA reading, DUST, windowing "
                            "and Smith-Waterman run their far slower "
                            "pure-Python path", reason, cache_reason)
                        return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            logger.warning(
                "native host library %s failed to load (%s): the host "
                "pipeline runs its far slower pure-Python path", so, e)
            return None
        _bind(lib)
        _LIB, _LIB_PATH = lib, so
        return _LIB


def available() -> bool:
    """True when the native path is live: not switched off with
    ``JAEGER_TPU_TORCH_NATIVE=0``, and the library built and loaded."""
    return os.environ.get(ENV_SWITCH, "1") != "0" and _load() is not None


def library_path() -> Path | None:
    """The loaded library's file, or None when it is not loaded."""
    return _LIB_PATH


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def read_fasta_native(path: str):
    """Yield (header, sequence) like seqops.fasta.read_fasta."""
    lib = _lib()
    handle = lib.jt_open_fasta(str(path).encode())
    if not handle:
        raise OSError(f"cannot open {path}")
    try:
        header = ctypes.c_char_p()
        seq = ctypes.c_char_p()
        while True:
            n = lib.jt_next_contig(handle, ctypes.byref(header),
                                   ctypes.byref(seq))
            if n < 0:
                # -1 is both clean EOF and read error (truncated/corrupt
                # gzip) — distinguish, or a partial read looks complete
                err = lib.jt_fasta_error(handle)
                if err:
                    msg = err.decode()
                    if str(path) not in msg:
                        msg = f"{msg} in {path}"
                    raise OSError(msg)
                break
            yield header.value.decode("ascii"), seq.value.decode("ascii")
    finally:
        lib.jt_close_fasta(handle)


def encode_ascii_native(seq: str):
    import numpy as np

    lib = _lib()
    raw = seq.encode("ascii")
    out = np.empty(len(raw), dtype=np.uint8)
    lib.jt_encode_ascii(raw, len(raw),
                        out.ctypes.data_as(ctypes.c_char_p))
    return out


def dust_intervals_native(seq: str, window: int = 64,
                          threshold: int = 20) -> list[tuple[int, int]]:
    lib = _lib()
    raw = seq.encode("ascii")
    cap = max(1024, len(seq) // 16)
    while True:
        buf = (ctypes.c_long * (cap * 2))()
        # returns the TOTAL interval count; > cap means the buffer was
        # too small and only cap pairs were written — retry larger
        n = lib.jt_sdust(raw, len(raw), window, threshold, buf, cap)
        if n <= cap:
            return [(buf[2 * i], buf[2 * i + 1]) for i in range(n)]
        cap = n


def dust_mask_native(seq: str, window: int = 64, threshold: int = 20) -> str:
    lib = _lib()
    buf = ctypes.create_string_buffer(seq.encode("ascii"), len(seq))
    lib.jt_dust_mask(buf, len(seq), window, threshold)
    return buf.raw[: len(seq)].decode("ascii")


def contig_ids_native(seq: str, dustmask: bool = True, window: int = 64,
                      threshold: int = 20):
    """Uppercase + SDUST + base-ID encode in one native call.

    Equivalent to ``encode_ascii(dust_mask(seq.upper()))`` but without the
    intermediate Python strings (hot path of ``seqops.windows``).
    """
    import numpy as np

    lib = _lib()
    raw = seq.encode("ascii")
    out = np.empty(len(raw), dtype=np.uint8)
    lib.jt_contig_ids(raw, len(raw), 1 if dustmask else 0, window,
                      threshold, out.ctypes.data_as(ctypes.c_char_p))
    return out


def window_counts_native(ids, starts, width: int):
    """(n_windows, 4) A/T/G/C counts over uppercase base IDs per window."""
    import numpy as np

    lib = _lib()
    ids = np.ascontiguousarray(ids, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    out = np.empty((starts.shape[0], 4), dtype=np.int64)
    lib.jt_window_counts(
        ids.ctypes.data_as(ctypes.c_char_p),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        starts.shape[0], width,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
    )
    return out


def contig_rows_native(seq: str, starts, fragsize: int, seqlen_meta: int,
                       dustmask: bool = True, window: int = 64,
                       threshold: int = 20):
    """The whole per-contig window loop in ONE GIL-released native call.

    Returns ``(wins, meta)``: ``wins`` is ``(n_windows, fragsize)`` uint8
    base IDs, ``meta`` is the ``(n_windows, 11)`` float64 batcher block
    ``[length, hidx=0, start, contig_end, ordinal, seqlen, g, c, a, t,
    gc_skew]``. ctypes drops the GIL for the call's full duration, so the
    ``window_batches(workers=N)`` thread pool scales with cores.
    Byte-identical to the pure-Python ``_contig_rows`` fallback
    (tests/test_torch_native.py).
    """
    import numpy as np

    lib = _lib()
    raw = seq.encode("ascii")
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    n_win = starts.shape[0]
    wins = np.empty((n_win, fragsize), dtype=np.uint8)
    meta = np.empty((n_win, 11), dtype=np.float64)
    lib.jt_contig_rows(
        raw, len(raw), 1 if dustmask else 0, window, threshold,
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), n_win,
        fragsize, seqlen_meta,
        wins.ctypes.data_as(ctypes.c_char_p),
        meta.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return wins, meta


def window_pipeline_native(path: str, fragsize: int, stride: int | None,
                           dynamic_stride: bool, dyn_threshold: float,
                           min_len: int, max_len: int | None,
                           dustmask: bool, batch_capacity: int,
                           workers: int):
    """Stream ``(bases, meta, new_headers)`` batches from the all-native
    window pipeline (reader thread + worker pool + ordered batcher in
    jaeger_host.cpp). One GIL-released call per batch; ``meta`` is the
    11-column float64 block of ``window_batches`` with the GLOBAL contig
    index already in column 1. Byte-identical to the Python pipeline
    (tests/test_torch_native.py).
    """
    import numpy as np

    lib = _lib()
    handle = lib.jt_pipeline_open(
        str(path).encode(), fragsize, -1 if stride is None else stride,
        1 if dynamic_stride else 0, float(dyn_threshold), min_len,
        -1 if max_len is None else max_len, 1 if dustmask else 0,
        64, 20, batch_capacity, workers,
    )
    if not handle:
        raise OSError(f"cannot open {path}")
    try:
        while True:
            bases = np.empty((batch_capacity, fragsize), dtype=np.uint8)
            meta = np.empty((batch_capacity, 11), dtype=np.float64)
            n = lib.jt_pipeline_next(
                handle, bases.ctypes.data_as(ctypes.c_char_p),
                meta.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
            if n < 0:
                err = lib.jt_pipeline_error(handle)
                raise OSError(err.decode() if err
                              else f"cannot read {path}")
            count = ctypes.c_long()
            total = lib.jt_pipeline_header_bytes(handle,
                                                 ctypes.byref(count))
            new_headers: list[str] = []
            if count.value:
                buf = ctypes.create_string_buffer(max(1, total))
                lens = (ctypes.c_long * count.value)()
                lib.jt_pipeline_drain_headers(handle, buf, lens)
                off = 0
                for i in range(count.value):
                    new_headers.append(
                        buf.raw[off: off + lens[i]].decode("ascii"))
                    off += lens[i]
            if n == 0 and not new_headers:
                break
            yield bases[:n], meta[:n], new_headers
            if n == 0:
                break
    finally:
        lib.jt_pipeline_close(handle)


def smith_waterman_native(query: str, ref: str, open_: int = 100,
                          extend: int = 5, match: int = 2,
                          mismatch: int = -100):
    """Returns an SWResult compatible with postprocess.sw."""
    from jaeger_tpu_torch.postprocess.sw import SWResult

    lib = _lib()
    cap = len(query) + len(ref) + 2
    q_out = ctypes.create_string_buffer(cap)
    r_out = ctypes.create_string_buffer(cap)
    end_q = ctypes.c_long()
    end_r = ctypes.c_long()
    score = lib.jt_smith_waterman(
        query.encode("ascii"), len(query), ref.encode("ascii"), len(ref),
        open_, extend, match, mismatch,
        ctypes.byref(end_q), ctypes.byref(end_r), q_out, r_out, cap,
    )
    qa = q_out.value.decode("ascii")
    ra = r_out.value.decode("ascii")
    comp = "".join(
        "|" if (a == b and a != "-" and a.upper() in "ACGT")
        else (" " if (a == "-" or b == "-") else ".")
        for a, b in zip(qa, ra)
    )
    return SWResult(
        score=int(score), end_query=int(end_q.value),
        end_ref=int(end_r.value), query_aligned=qa, ref_aligned=ra,
        comp=comp,
    )
