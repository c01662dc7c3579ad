"""The port's ``predict`` stages (``--mask-tandem``, ``--prophage``,
``--refine``, ``--profile``) against the JAX package on the same inputs.

Module by module: tandem masking (masked FASTA bytes), change points and
knees, gene-snapped prophage boundaries, segmentation with the att report
(report bytes), refinement and contig aggregation (frames equal). Then
``run_core`` end to end at float32 on the CPU against JAX ``run_core`` on
the same FASTA and bundle: each stage's TSVs byte-identical. Inputs are
made from numpy seeds; the 6-class bundle for ``--refine`` is a narrow
flagship initialized by JAX, whose weights the port reads through
``params_from_jax`` when it loads the bundle.
"""

import copy
import json
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest

from jaeger_tpu.commands.predict import _build_refined_contig_df as jax_brcd
from jaeger_tpu.commands.predict import run_core as jax_run_core
from jaeger_tpu.models.artifacts import save_model as jax_save_model
from jaeger_tpu.models.builder import ModelBuilder
from jaeger_tpu.models.flagship import _inline_flagship
from jaeger_tpu.postprocess import cpd as jax_cpd
from jaeger_tpu.postprocess import genes as jax_genes
from jaeger_tpu.postprocess import prophages as jax_pro
from jaeger_tpu.postprocess import refinement as jax_ref
from jaeger_tpu.seqops import tandem as jax_tandem
from jaeger_tpu_torch import cli
from jaeger_tpu_torch.commands.predict import _build_refined_contig_df
from jaeger_tpu_torch.postprocess import cpd, genes, prophages, refinement
from jaeger_tpu_torch.seqops import tandem

ROOT = Path(__file__).resolve().parents[1]
FASTA = ROOT / "jaeger_tpu" / "data" / "test" / "test_contigs.fasta"
DEMO = ROOT / "jaeger_tpu" / "data" / "models" / "demo"
STOPS = {"TAA", "TAG", "TGA"}
CODONS = [a + b + c for a in "ACGT" for b in "ACGT" for c in "ACGT"
          if a + b + c not in STOPS]
FSIZE = 500
CLASS_MAP = {"index": [0, 1, 2, 3],
             "class": ["bacteria", "phage", "eukaryota", "archaea"]}


def _dna(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


def _genome(rng, n):
    """Random intergenic DNA with planted genes (RBS, ATG, non-stop
    codons, TAA) on both strands, cut to ``n`` nt."""
    comp = str.maketrans("ACGT", "TGCA")
    parts, size = [], 0
    while size < n:
        gene = ("ATG" + "".join(rng.choice(CODONS,
                                           size=int(rng.integers(150, 400))))
                + "TAA")
        if rng.random() < 0.5:
            gene = gene.translate(comp)[::-1]
        for p in (_dna(rng, int(rng.integers(40, 200))), "AGGAGG",
                  _dna(rng, 7), gene):
            parts.append(p)
            size += len(p)
    return "".join(parts)[:n]


# --- modules -----------------------------------------------------------------

def test_mask_fasta_byte_equal(tmp_path):
    rng = np.random.default_rng(0)
    recs = []
    for i, (unit, n) in enumerate((("GATTACAGGC", 30), ("AC", 60),
                                   ("TTAGGGTTAGGA", 12), ("", 0))):
        tract = unit * n
        recs.append((f"ctg{i} desc", _dna(rng, 700) + tract + _dna(rng, 650)))
    src = tmp_path / "in.fasta"
    src.write_text("".join(f">{h}\n{s}\n" for h, s in recs))
    n_jax = jax_tandem.mask_fasta(str(src), str(tmp_path / "jax.fasta"),
                                  workers=2)
    n_port = tandem.mask_fasta(str(src), str(tmp_path / "port.fasta"),
                               workers=2)
    assert n_port == n_jax > 0
    assert ((tmp_path / "port.fasta").read_bytes()
            == (tmp_path / "jax.fasta").read_bytes())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cpd_and_knee_equal(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(60, 200))
    cuts = np.sort(rng.choice(np.arange(5, n - 5), size=3, replace=False))
    signal = rng.normal(0, 0.4, size=n)
    for lo, hi in zip(np.r_[0, cuts], np.r_[cuts, n]):
        signal[lo:hi] += rng.normal(0, 2)
    lens = []
    for pen in range(1, 10):
        want = jax_cpd.kernel_cpd_linear(signal, pen=pen, min_size=3)
        got = cpd.kernel_cpd_linear(signal, pen=pen, min_size=3)
        assert list(got) == list(want)
        lens.append(len(got))
    for x in (lens, sorted(rng.integers(1, 40, size=9).tolist())[::-1]):
        y = list(range(len(x)))
        assert (cpd.KneeLocator(x, y, curve="convex",
                                direction="decreasing").knee
                == jax_cpd.KneeLocator(x, y, curve="convex",
                                       direction="decreasing").knee)


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    """A 60 kb contig with planted genes and a planted prophage (windows
    40..70 of 120) whose raw boundaries carry a 60 bp direct repeat, a
    40 kb contig with no region and a contig under the cutoff."""
    rng = np.random.default_rng(11)
    n_win = 120
    seq = list(_genome(rng, n_win * FSIZE))
    att = _dna(rng, 60)
    for at in (41 * FSIZE, 71 * FSIZE):
        seq[at - 30: at + 30] = att
    seq = "".join(seq)
    logits = rng.normal(0.0, 0.3, size=(n_win, 4)).astype(np.float32)
    logits[:, 0] += 1.0
    logits[40:70, 1] += 5.0
    logits[40:70, 0] -= 1.0
    quiet = rng.normal(0.0, 0.3, size=(80, 4)).astype(np.float32)
    quiet[:, 0] += 1.0
    small = rng.normal(0.0, 0.3, size=(20, 4)).astype(np.float32)
    fasta = tmp_path_factory.mktemp("prophage") / "contigs.fasta"
    seqs = [seq, _genome(rng, 80 * FSIZE), _dna(rng, 20 * FSIZE)]
    headers = ["big,contig", "quiet", "small"]
    fasta.write_text("".join(f">{h}\n{s}\n" for h, s in zip(headers, seqs)))
    preds = [logits, quiet, small]
    return dict(
        fasta=fasta,
        kwargs=dict(
            headers=np.array([h.replace(",", "___") for h in headers]),
            predictions=preds,
            lengths=np.array([len(s) for s in seqs]),
            gc_skews=[rng.uniform(-0.4, 0.4, size=len(p)) for p in preds],
            gcs=[rng.uniform(0.3, 0.7, size=len(p)) for p in preds]),
        kw={"lc": 30_000, "fsize": FSIZE, "stride": FSIZE},
    )


def test_refine_prophage_boundaries_equal(scenario):
    cords = {"big___contig": [np.array([[40, 70], [90, 100]]),
                              np.array([3.1, 2.0])],
             "quiet": [[], []]}
    want = jax_genes.refine_prophage_boundaries(cords, scenario["fasta"],
                                                FSIZE, stride=FSIZE)
    got = genes.refine_prophage_boundaries(cords, scenario["fasta"], FSIZE,
                                           stride=FSIZE)
    assert got == want
    # the planted genes moved at least one boundary off the window grid
    assert any((a, b) != (c, d) for a, b, c, d in got["big___contig"])


def test_segment_and_report_byte_equal(scenario, tmp_path):
    kw = scenario["kw"]
    want_df = jax_pro.logits_to_df_v2(CLASS_MAP, kw, **scenario["kwargs"])
    got_df = prophages.logits_to_df_v2(CLASS_MAP, kw, **scenario["kwargs"])
    assert set(got_df) == set(want_df) == {"big___contig", "quiet"}
    for key in want_df:
        pd.testing.assert_frame_equal(got_df[key][0], want_df[key][0])
        assert got_df[key][1:] == want_df[key][1:]
    want = jax_pro.segment(want_df, cutoff_length=kw["lc"], sensitivity=1.5)
    got = prophages.segment(got_df, cutoff_length=kw["lc"], sensitivity=1.5)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key][0], want[key][0])
        np.testing.assert_array_equal(got[key][1], want[key][1])
    assert len(got["big___contig"][0]) == 1
    refined = genes.refine_prophage_boundaries(got, scenario["fasta"], FSIZE,
                                               stride=FSIZE)
    for side, mod, cords in (("jax", jax_pro, want), ("port", prophages, got)):
        mod.prophage_report(fsize=FSIZE, filehandle=scenario["fasta"],
                            prophage_cordinates=cords, outdir=tmp_path / side,
                            refined_boundaries=refined, stride=FSIZE,
                            cutoff_length=kw["lc"])
    report = (tmp_path / "port" / "prophages_jaeger.tsv").read_bytes()
    assert report == (tmp_path / "jax" / "prophages_jaeger.tsv").read_bytes()
    assert b"big,contig" in report and b"DTR" in report
    plots = prophages.plot_scores_linear(
        got_df, fsize=FSIZE, infile_base="contigs", outdir=tmp_path / "plots",
        phage_cordinates=got, stride=FSIZE)
    assert plots and all(p.exists() and p.stat().st_size > 0 for p in plots)


def _window_df(rng, n_contigs=6):
    rows = []
    for c in range(n_contigs):
        for w in range(int(rng.integers(2, 9))):
            scores = rng.normal(0, 1.5, size=6)
            scores[c % 6] += 1.0
            row = {"contig_id": f"c{c}", "window_idx": w}
            row.update(dict(zip(refinement.SCORE_COLS, scores)))
            rows.append(row)
    return pd.DataFrame(rows)


def _taus(rng):
    return {k: {"logit": float(rng.uniform(-0.5, 1.0)),
                "margin": float(rng.uniform(0.0, 0.8)), "n": 50}
            for k in refinement.CLASSES}


@pytest.mark.parametrize("mode,merge_split,allow_merged", [
    ("gated", "half", False), ("weighted", "full", True),
    ("unweighted", "half", True)])
def test_refine_and_aggregate_equal(mode, merge_split, allow_merged):
    rng = np.random.default_rng(5)
    df, taus = _window_df(rng), _taus(rng)
    want = jax_ref.refine(jax_ref.add_score_features(df), taus)
    got = refinement.refine(refinement.add_score_features(df), taus)
    pd.testing.assert_frame_equal(got, want)
    kw = dict(mode=mode, min_windows=2, merge_split=merge_split,
              allow_merged_contig_call=allow_merged, contig_hedge_margin=0.5)
    agg = refinement.aggregate_contig(got, **kw)
    pd.testing.assert_frame_equal(agg, jax_ref.aggregate_contig(want, **kw))
    assert len(agg)


def test_refinement_all_abstain_falls_back_to_unrefined():
    """Taus that abstain every window: no refined frame, as in JAX."""
    rng = np.random.default_rng(42)
    harsh = {c: {"logit": 1e9, "margin": 1e9, "n": 10}
             for c in refinement.CLASSES}
    data_full = {
        "headers": ["c1", "c2"],
        "predictions": [np.asarray(rng.normal(size=(5, 6)), np.float32),
                        np.asarray(rng.normal(size=(4, 6)), np.float32)],
    }
    assert jax_brcd(data_full, harsh) is None
    assert _build_refined_contig_df(data_full, harsh) is None


# --- run_core end to end -----------------------------------------------------

def _port_predict(args):
    cli.main(["predict", "--precision", "float32", "--device", "cpu",
              "--workers", "1", *args])


def test_run_core_mask_tandem_tsv_byte_identical(tmp_path):
    rng = np.random.default_rng(3)
    seq = _dna(rng, 700) + "GATTACAGGC" * 30 + _dna(rng, 700)
    fasta = tmp_path / "rep.fasta"
    fasta.write_text(f">ctg0\n{seq}\n>ctg1\n{_dna(rng, 1500)}\n")
    common = dict(fsize=400, stride=400, batch=16, min_len=300,
                  reliability_cutoff=0.1, phage_score=3.0)
    want = jax_run_core(str(fasta), str(tmp_path / "jax"), str(DEMO),
                        precision="float32", mask_tandem=True, **common)
    _port_predict(["-i", str(fasta), "-o", str(tmp_path / "port"),
                   "--fsize", "400", "--stride", "400", "--batch", "16",
                   "--min-len", "300", "--mask-tandem"])
    masked = "rep_tandem_masked.fasta"
    assert ((tmp_path / "port" / masked).read_bytes()
            == (tmp_path / "jax" / masked).read_bytes())
    assert (tmp_path / "port" / want.name).read_bytes() == want.read_bytes()


def test_run_core_prophage_tsvs_byte_identical(tmp_path):
    """A host contig holding one of the test phage contigs, at a small
    ``lc`` and a sensitivity the demo model's phage track reaches."""
    from jaeger_tpu_torch.seqops.fasta import read_fasta

    recs = list(read_fasta(str(FASTA)))
    rng = np.random.default_rng(5)
    host = _dna(rng, 30_000) + recs[0][1] + _dna(rng, 30_000)
    fasta = tmp_path / "pro.fasta"
    fasta.write_text(f">host,1\n{host}\n>{recs[2][0]}\n{recs[2][1]}\n"
                     f">short\n{_dna(rng, 3000)}\n")
    jax_run_core(str(fasta), str(tmp_path / "jax"), str(DEMO), fsize=500,
                 stride=500, batch=96, precision="float32",
                 reliability_cutoff=0.1, phage_score=3.0, prophage=True,
                 lc=20_000, sensitivity=0.3, plot_type="none")
    _port_predict(["-i", str(fasta), "-o", str(tmp_path / "port"),
                   "--fsize", "500", "--stride", "500", "-p", "--lc",
                   "20000", "-s", "0.3", "--plot-type", "none"])
    want = sorted(p.relative_to(tmp_path / "jax")
                  for p in (tmp_path / "jax").rglob("*.tsv"))
    got = sorted(p.relative_to(tmp_path / "port")
                 for p in (tmp_path / "port").rglob("*.tsv"))
    assert got == want
    assert len(want) == 2          # the summary and prophages_jaeger.tsv
    for rel in want:
        assert ((tmp_path / "port" / rel).read_bytes()
                == (tmp_path / "jax" / rel).read_bytes()), rel


def _randomize(variables, seed):
    """Random norms, biases and moving statistics, so that every
    parameter shapes the logits."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        name = path[-1].key
        if name in ("kernel", "embedding"):
            return x
        if name in ("gamma", "moving_variance"):
            return (1.0 + 0.3 * rng.random(x.shape)).astype(np.float32)
        if name == "alpha":
            return (0.5 + rng.random(x.shape)).astype(np.float32)
        return (0.3 * rng.normal(size=x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope="module")
def narrow_flagship(tmp_path_factory):
    """The flagship's layout and 6 classes at 16 channels, with a seeded
    ``<name>_refine.yaml`` beside it."""
    cfg = copy.deepcopy(_inline_flagship())
    cfg["model"]["name"] = "narrow_flagship"
    cfg["model"]["embedding"]["embedding_size"] = 16
    for layer in cfg["model"]["representation_learner"]["hidden_layers"]:
        if "filters" in layer.get("config", {}):
            layer["config"]["filters"] = 16
    _, variables = ModelBuilder(cfg).init(batch=1)
    variables = _randomize(jax.tree_util.tree_map(np.asarray, variables), 7)
    path = tmp_path_factory.mktemp("bundles") / "narrow_flagship"
    jax_save_model(variables, cfg, path)
    rng = np.random.default_rng(9)
    taus = {k: {"logit": float(rng.uniform(-1.0, 0.5)),
                "margin": float(rng.uniform(0.0, 0.3)), "n": 100}
            for k in refinement.CLASSES}
    refinement.save_refinement(taus, path / "narrow_flagship_refine.yaml",
                               jaeger_model="narrow_flagship", quantile=0.05)
    return path


def test_run_core_refine_tsv_byte_identical(narrow_flagship, tmp_path):
    want = jax_run_core(str(FASTA), str(tmp_path / "jax"),
                        str(narrow_flagship), fsize=2000, stride=1500,
                        batch=96, precision="float32",
                        reliability_cutoff=0.1, phage_score=3.0, refine=True,
                        refine_min_windows=2)
    _port_predict(["-i", str(FASTA), "-o", str(tmp_path / "port"), "-m",
                   str(narrow_flagship), "--refine", "--refine-min-windows",
                   "2"])
    got = (tmp_path / "port" / want.name).read_bytes()
    assert got == want.read_bytes()
    table = pd.read_table(tmp_path / "port" / want.name)
    assert "contig_call" in table and table["contig_call"].notna().any()


def test_run_core_profile_writes_trace(tmp_path):
    _port_predict(["-i", str(FASTA), "-o", str(tmp_path), "--no-termini",
                   "--profile"])
    trace = tmp_path / "profile" / "predict_trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name") == "predict.inference" for e in events)
    assert (tmp_path / "test_contigs_default_jaeger.tsv").exists()


def test_run_core_profile_trace_names_the_program_spans(tmp_path):
    """The ``--profile`` trace holds the program's own ranges: the
    windowing calls, the engine's phases and the model's layers."""
    _port_predict(["-i", str(FASTA), "-o", str(tmp_path), "--no-termini",
                   "--profile"])
    trace = tmp_path / "profile" / "predict_trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"windowing/next", "engine/batch", "engine/plan",
            "engine/forward", "engine/drain"} <= names
    assert {"model/encode", "model/residual_block", "model/heads"} <= names
