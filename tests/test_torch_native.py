"""The port's native host library against the JAX package's.

``jaeger_tpu_torch/native`` is a copy of ``jaeger_tpu/native`` that builds
its own library into ``build/jaeger_tpu_torch/``. Each case runs the same
numpy-seeded input through the port's native path, the port's pure-Python
path (``JAEGER_TPU_TORCH_NATIVE=0``) and the JAX package, and requires
equal output: strings, intervals and every ``WindowBatch`` field byte for
byte. The cases follow ``tests/test_native.py``.
"""

import gzip
import logging
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from jaeger_tpu.postprocess.sw import smith_waterman as jax_sw
from jaeger_tpu.seqops import dust as jax_dust
from jaeger_tpu.seqops import windows as jax_windows
from jaeger_tpu.seqops.fasta import read_fasta as jax_read_fasta
from jaeger_tpu_torch import native
from jaeger_tpu_torch.postprocess.sw import smith_waterman
from jaeger_tpu_torch.seqops import windows as W
from jaeger_tpu_torch.seqops.dust import dust_mask
from jaeger_tpu_torch.seqops.fasta import read_fasta

ROOT = Path(__file__).resolve().parents[1]
SW_FIELDS = ("score", "end_query", "end_ref", "query_aligned", "ref_aligned",
             "comp")
BATCH_FIELDS = ("bases", "length", "contig", "start", "contig_end",
                "ordinal", "seqlen", "g", "c", "a", "t", "gc_skew")


@pytest.fixture(autouse=True)
def _native_on(monkeypatch):
    monkeypatch.setenv("JAEGER_TPU_TORCH_NATIVE", "1")
    monkeypatch.setenv("JAEGER_TPU_NATIVE", "1")
    assert native.available()


def _dna(rng, n, alphabet="ACGT"):
    return "".join(rng.choice(list(alphabet), size=n))


@pytest.mark.parametrize("gz", [False, True])
def test_fasta_reader_matches_python_and_jax(tmp_path, monkeypatch, gz):
    rng = np.random.default_rng(0)
    text = (f">seq one desc\n{_dna(rng, 70)}\n{_dna(rng, 33)}\n\n"
            f">seq_two\n{_dna(rng, 200, 'ACGTNacgt')}\n>empty\n>last\nTT\n")
    path = tmp_path / ("t.fasta.gz" if gz else "t.fasta")
    if gz:
        with gzip.open(path, "wt") as fh:
            fh.write(text)
    else:
        path.write_text(text)
    nat = list(native.read_fasta_native(str(path)))
    assert nat == list(W._fasta_source(str(path)))
    monkeypatch.setenv("JAEGER_TPU_TORCH_NATIVE", "0")
    assert list(W._fasta_source(str(path))) == nat
    assert list(read_fasta(path)) == nat
    assert list(jax_read_fasta(path)) == nat
    assert len(nat) == 4


def test_truncated_gzip_raises(tmp_path):
    """A truncated .gz raises from the reader and from the window
    pipeline; what was read before the error is not looked at."""
    rng = np.random.default_rng(1)
    path = tmp_path / "t.fasta.gz"
    with gzip.open(path, "wt") as fh:
        fh.write(f">a\n{_dna(rng, 1600)}\n>b\n{_dna(rng, 1600)}\n")
    raw = path.read_bytes()
    trunc = tmp_path / "trunc.fasta.gz"
    trunc.write_bytes(raw[: len(raw) // 2])
    with pytest.raises(OSError, match="decompression|read"):
        list(native.read_fasta_native(str(trunc)))
    with pytest.raises(OSError, match="decompression|read"):
        for _ in native.window_pipeline_native(
                str(trunc), 500, None, False, 0.1, 100, None, False, 64, 2):
            pass
    with pytest.raises(OSError, match="cannot open"):
        for _ in native.window_pipeline_native(
                str(tmp_path / "nope.fa"), 500, None, False, 0.1, 100, None,
                False, 64, 2):
            pass


def _dust_cases():
    rng = np.random.default_rng(2)
    cases = [
        _dna(rng, 300) + "A" * 60 + _dna(rng, 300),
        "ATATATATATATATATAT" * 10 + _dna(rng, 200),
        _dna(rng, 150) + "N" * 10 + "A" * 31 + _dna(rng, 150),
        _dna(rng, 400),
        "".join(rng.choice(list("ACGT"), p=[.4, .1, .1, .4], size=900)),
    ]
    # planted repeats of several periods
    chars = list(_dna(rng, 1500))
    for at, unit in ((100, "CAG"), (700, "TTAGGG"), (1200, "AT")):
        chars[at:at + 80] = list((unit * 40)[:80])
    cases.append("".join(chars))
    return cases


@pytest.mark.parametrize("case", range(6))
def test_dust_matches_python_and_jax(monkeypatch, case):
    s = _dust_cases()[case]
    iv = native.dust_intervals_native(s)
    assert iv == jax_dust.dust_intervals(s)
    masked = dust_mask(s)
    assert masked == native.dust_mask_native(s)
    monkeypatch.setenv("JAEGER_TPU_NATIVE", "0")
    assert jax_dust.dust_mask(s) == masked
    monkeypatch.setenv("JAEGER_TPU_TORCH_NATIVE", "0")
    assert dust_mask(s) == masked


def test_dust_many_intervals_match_jax():
    """More than 2048 intervals (each poly-A split by an N) are all
    masked, as by the JAX package's native masker. The Python oracle
    takes minutes on this input, so the native paths are compared."""
    from jaeger_tpu import native as jax_native

    rng = np.random.default_rng(2)
    s = "".join("A" * 40 + _dna(rng, 24) + "N" for _ in range(2200))
    iv = native.dust_intervals_native(s)
    assert len(iv) > 2048
    assert iv == jax_native.dust_intervals_native(s)
    masked = dust_mask(s)
    assert all(masked[a:b].islower() for a, b in iv)
    assert sum(c.islower() for c in masked) == sum(b - a for a, b in iv)


@pytest.mark.parametrize("case", ["repeat", "gap", "no_match"])
def test_smith_waterman_matches_numpy_and_jax(monkeypatch, case):
    rng = np.random.default_rng(3)
    if case == "repeat":
        core, rep = _dna(rng, 400), _dna(rng, 50)
        q, r = rep + core[:200], core[200:] + rep
    elif case == "gap":
        a = _dna(rng, 120)
        q, r = a, a[:60] + "GT" + a[60:]
    else:
        q, r = "AAAA", "GGGG"
    nat = smith_waterman(q, r)
    monkeypatch.setenv("JAEGER_TPU_NATIVE", "0")
    ref = jax_sw(q, r)
    monkeypatch.setenv("JAEGER_TPU_TORCH_NATIVE", "0")
    py = smith_waterman(q, r)
    for f in SW_FIELDS:
        assert getattr(nat, f) == getattr(py, f) == getattr(ref, f), f
    if case == "no_match":
        assert nat.score <= 2


def test_contig_rows_matches_python_and_jax(monkeypatch):
    """The one-call per-contig window loop across regimes: random DNA,
    tandem repeats (DUST fires), Ns, soft-masked lowercase and dynamic
    stride."""
    rng = np.random.default_rng(7)
    alphabet = list("ATGCatgcN")
    probs = [.22, .22, .22, .22, .02, .02, .02, .02, .04]
    for trial in range(10):
        n = int(rng.integers(400, 6000))
        seq = "".join(rng.choice(alphabet, p=probs, size=n))
        if trial % 3 == 0:
            seq = seq[:50] + "ATATATATAT" * 5 + seq[50:]
        if trial % 5 == 0:
            seq = seq[:20] + "N" * 30 + seq[20:]
        args = ("ctg,x", seq, 500, 300, trial % 4 == 0, 10.0, 200, True)
        monkeypatch.setenv("JAEGER_TPU_TORCH_NATIVE", "1")
        h1, w1, m1 = W._contig_rows(*args)
        monkeypatch.setenv("JAEGER_TPU_TORCH_NATIVE", "0")
        h2, w2, m2 = W._contig_rows(*args)
        monkeypatch.setenv("JAEGER_TPU_NATIVE", "0")
        h3, w3, m3 = jax_windows._contig_rows(*args)
        assert h1 == h2 == h3
        assert (w1 is None) == (w2 is None) == (w3 is None)
        if w1 is not None:
            assert np.array_equal(w1, w2) and np.array_equal(w1, w3), trial
            assert np.array_equal(m1, m2) and np.array_equal(m1, m3), trial


def test_gc_skew_rounding_matches_python_round():
    """The native 2-decimal skew equals CPython round((g-c)/(g+c), 2),
    including the half-way-straddling values where np.round's
    scale-by-100 disagrees."""
    rng = np.random.default_rng(3)
    gs = np.concatenate([rng.integers(0, 2000, 400),
                         np.array([0, 1, 2, 125, 875])])
    cs = np.concatenate([rng.integers(0, 2000, 400),
                         np.array([0, 2, 1, 875, 125])])
    for g, c in zip(gs.tolist(), cs.tolist()):
        seq = "G" * g + "C" * c + "AT" * 10
        _, meta = native.contig_rows_native(
            seq, np.zeros(1, np.int64), len(seq), len(seq), dustmask=False)
        assert meta[0, 10] == W._gc_skew(g, c) == jax_windows._gc_skew(g, c)


def _synth_fasta(path, rng, n_contigs=24):
    """Random DNA with soft-masked bases and Ns, tandem repeats (DUST
    fires), N runs, sub-min contigs and long contigs that trip dynamic
    stride."""
    alphabet = list("ATGCatgcN")
    probs = [.22, .22, .22, .22, .02, .02, .02, .02, .04]
    with open(path, "w") as fh:
        for i in range(n_contigs):
            if i % 13 == 5:
                n = int(rng.integers(40, 400))
            elif i % 10 == 3:
                n = int(rng.integers(30_000, 45_000))
            else:
                n = int(rng.integers(600, 9_000))
            seq = "".join(rng.choice(alphabet, p=probs, size=n))
            if i % 6 == 0:
                # short: the Python DUST oracle is slow on repeats
                seq = seq[:64] + "ACACACACAC" * 5 + seq[64:]
            if i % 4 == 1:
                seq = seq[:100] + "N" * int(rng.integers(10, 120)) + seq[100:]
            fh.write(f">contig_{i} desc,{i}\n")
            for j in range(0, len(seq), 80):
                fh.write(seq[j: j + 80] + "\n")


@pytest.fixture(scope="module")
def synth_fasta(tmp_path_factory):
    path = tmp_path_factory.mktemp("native") / "p.fasta"
    _synth_fasta(path, np.random.default_rng(11))
    return path


@pytest.mark.parametrize("dyn", [False, True])
@pytest.mark.parametrize("workers", [1, 4])
def test_window_batches_match_jax_and_python(synth_fasta, monkeypatch, dyn,
                                             workers):
    """The port's all-native window pipeline against the JAX native
    pipeline, the JAX Python path and the port's Python path: every
    field, batch boundary and header."""

    def run(fn, torch_native, jax_native):
        monkeypatch.setenv("JAEGER_TPU_TORCH_NATIVE", torch_native)
        monkeypatch.setenv("JAEGER_TPU_NATIVE", jax_native)
        return list(fn(str(synth_fasta), fragsize=2000, stride=1500,
                       dynamic_stride=dyn, min_len=500, batch_capacity=61,
                       workers=workers))

    port = run(W.window_batches, "1", "0")
    others = {"jax native": run(jax_windows.window_batches, "0", "1"),
              "jax python": run(jax_windows.window_batches, "0", "0"),
              "port python": run(W.window_batches, "0", "0")}
    assert len(port) > 2
    for name, got in others.items():
        assert len(got) == len(port), name
        for k, (a, b) in enumerate(zip(port, got)):
            for f in BATCH_FIELDS:
                va, vb = getattr(a, f), getattr(b, f)
                assert va.dtype == vb.dtype and np.array_equal(va, vb), \
                    (name, k, f)
            assert a.headers == b.headers, (name, k)


def test_loads_its_own_library():
    """The port maps its own ``build/jaeger_tpu_torch/libjaeger_host-*.so``
    and never the JAX package's library, even after windowing a file."""
    code = (
        "from jaeger_tpu_torch import native\n"
        "from jaeger_tpu_torch.seqops.windows import window_batches\n"
        "n = sum(len(b) for b in window_batches("
        "'jaeger_tpu/data/test/test_contigs.fasta', fragsize=2000, "
        "stride=2000, min_len=500))\n"
        "maps = open('/proc/self/maps').read()\n"
        "print(n, native.library_path())\n"
        "print('jax_lib_mapped', 'jaeger_tpu/native/libjaeger_host' in maps)\n"
        "print('port_lib_mapped', str(native.library_path()) in maps)\n"
    )
    env = {k: v for k, v in __import__("os").environ.items()
           if k != "JAEGER_TPU_TORCH_NATIVE"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.split("\n")
    n, lib = lines[0].split(" ", 1)
    assert n == "103"
    lib = Path(lib)
    assert lib.parent == ROOT / "build" / "jaeger_tpu_torch"
    assert lib.name.startswith("libjaeger_host-") and lib.suffix == ".so"
    assert "jax_lib_mapped False" in proc.stdout
    assert "port_lib_mapped True" in proc.stdout


def test_switch_forces_python_for_the_port_only(monkeypatch):
    from jaeger_tpu import native as jax_native

    monkeypatch.setenv("JAEGER_TPU_TORCH_NATIVE", "0")
    assert not native.available()
    assert jax_native.available()


def test_cache_fallback_when_build_dir_unwritable(monkeypatch, tmp_path):
    """A build directory that cannot be created sends the build to the
    user cache, under the port's own subdirectory."""
    blocker = tmp_path / "file"
    blocker.write_text("")
    monkeypatch.setattr(native, "BUILD_DIR", blocker / "build")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LIB_PATH", None)
    monkeypatch.setattr(native, "_TRIED", False)
    assert native.available()
    cached = list((tmp_path / "cache" / "jaeger_tpu_torch").glob("*.so"))
    assert [native.library_path()] == cached


def test_failed_build_warns_and_falls_back(monkeypatch, tmp_path, caplog):
    """A source that does not compile: the loader warns with g++'s error
    and the Python path still gives the same windows."""
    bad = tmp_path / "jaeger_host.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LIB_PATH", None)
    monkeypatch.setattr(native, "_TRIED", False)
    with caplog.at_level(logging.WARNING, logger="jaeger_tpu_torch"):
        assert not native.available()
    msg = " ".join(r.getMessage() for r in caplog.records
                   if r.levelno == logging.WARNING)
    assert "g++ failed" in msg and "error" in msg
    n = sum(len(b) for b in W.window_batches(
        str(ROOT / "jaeger_tpu" / "data" / "test" / "test_contigs.fasta"),
        fragsize=2000, stride=2000, min_len=500))
    assert n == 103
