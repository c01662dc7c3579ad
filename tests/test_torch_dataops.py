"""The port's host copies (``utils/{stats,receptive_field}.py``,
``seqops/{stats,transform,synthetic}.py``,
``dataops/{split,ood,dedupe,convert}.py``) and its ``utils`` data
commands against `jaeger_tpu`, with the same seeds.

Each copy draws from the same generator as its JAX module, in the same
order, so the same seed gives the same result: text outputs are compared
byte for byte, NPZ outputs array by array (``np.savez_compressed`` stamps
the time into its zip entries), the ``stats`` summary and
``jaeger_output_with_pvals.tsv`` as they are written. Where a JAX module
draws from an unseeded ``np.random.default_rng()`` (the OOD shuffles),
both runs get the same seeded generator through a monkeypatch.
"""

import json
import os
import random
import stat
from pathlib import Path

import numpy as np
import pytest
from click.testing import CliRunner

from jaeger_tpu import cli as jcli
from jaeger_tpu_torch import cli

ROOT = Path(__file__).resolve().parent.parent
FASTA = ROOT / "jaeger_tpu" / "data" / "test" / "test_contigs.fasta"
TEMPLATES = sorted((ROOT / "train_config").glob("*.yaml"))


def _seqs(rng, n, lo, hi, alphabet="ACGT"):
    letters = np.array(list(alphabet))
    return ["".join(letters[rng.integers(0, len(alphabet),
                                         size=int(rng.integers(lo, hi)))])
            for _ in range(n)]


def _reseed(seed=11):
    random.seed(seed)
    np.random.seed(seed)


# --- host copies ---------------------------------------------------------------

def _host_cases():
    """(name, call(module_root) -> result) pairs; module_root is
    ``jaeger_tpu`` or ``jaeger_tpu_torch``."""
    import importlib

    def mod(root, name):
        return importlib.import_module(f"{root}.{name}")

    rng = np.random.default_rng(3)
    seqs = _seqs(rng, 6, 50, 400) + ["NNNNACGT", "A", "", "ACGTRYKMN"]
    lg1, lg2 = rng.normal(1, 1, 30), rng.normal(0.5, 1, 30)

    def gen_call(fn):
        """Run fn with both global streams and a Generator seeded alike."""
        def call(root):
            _reseed()
            return fn(root, np.random.default_rng(5))
        return call

    cases = {
        "utils.stats.significant_top_class": lambda r: mod(
            r, "utils.stats").significant_top_class(lg1, lg2),
        "utils.stats.welch": lambda r: [mod(r, "utils.stats")
                                        .welch_t_one_tailed(
            0.7, 0.02, 12, 0.4, 0.05, 9, alt) for alt in ("greater", "less")],
        "seqops.stats": lambda r: [
            [getattr(mod(r, "seqops.stats"), f)(s) for f in
             ("shannon_entropy", "gc_content", "percentage_of_n", "gc_skew")]
            for s in seqs if s],
        "transform.reverse_complement": lambda r: [
            mod(r, "seqops.transform").reverse_complement(s) for s in seqs],
        "transform.shuffles": gen_call(lambda r, g: [
            (mod(r, "seqops.transform").shuffle_dna(s, g),
             mod(r, "seqops.transform").kmer_shuffle(s, 3, g),
             mod(r, "seqops.transform").dinuc_shuffle(s, rng=g),
             mod(r, "seqops.transform").dinuc_shuffle(s, 3, np.random))
            for s in seqs]),
        "synthetic.generators": gen_call(lambda r, g: (
            mod(r, "seqops.synthetic").generate_random_tandem_repeats(
                3, max_len=300),
            mod(r, "seqops.synthetic").generate_biased_sequence(200),
            mod(r, "seqops.synthetic").generate_low_entropy_sequence(60, 20, 1.9),
            mod(r, "seqops.synthetic").generate_homopolymer(7, "G"))),
        "synthetic.windows": gen_call(lambda r, g: [
            (mod(r, "seqops.synthetic").apply_shuffle(s),
             mod(r, "seqops.synthetic").apply_dinuc_shuffle(s),
             mod(r, "seqops.synthetic").apply_kmer_shuffle(s, 3),
             mod(r, "seqops.synthetic").apply_subseq_repeat_window(s),
             mod(r, "seqops.synthetic").apply_tandem_repeat_window(
                 s, num_repeats=2),
             mod(r, "seqops.synthetic").apply_n_stretch(s))
            for s in seqs[:6]]),
        "synthetic.apply_mix": gen_call(lambda r, g: [
            mod(r, "seqops.synthetic").apply_mix(seqs[:4], n)
            for n in (None, 0, 2, 150, 1000)]),
        "dedupe.sketches": lambda r: [
            (mod(r, "dataops.dedupe").minhash_sketch(s).tolist(),
             mod(r, "dataops.dedupe").minhash_sketch_aa(s).tolist())
            for s in seqs[:6]],
        "dedupe.deduper": lambda r: [
            [mod(r, "dataops.dedupe").MinHashDeduper(
                threshold=0.5, mode=m).is_duplicate(s) for s in
             seqs[:6] + seqs[:3]] for m in ("nt", "aa")],
        "receptive_field": lambda r: [
            mod(r, "utils.receptive_field").receptive_field_summary(
                _hidden_layers(p), crop_size=500) for p in TEMPLATES],
        "convert.encoders": lambda r: _encoders(mod(r, "dataops.convert")),
    }
    return cases


def _hidden_layers(path):
    import yaml

    rep = yaml.safe_load(Path(path).read_text())["model"][
        "representation_learner"]
    return rep.get("branch", rep).get("hidden_layers", [])


def _encoders(convert):
    rng = np.random.default_rng(9)
    bases = rng.integers(0, 9, size=(7, 120)).astype(np.uint8)
    lengths = np.array([120, 119, 118, 60, 3, 2, 0], np.int32)
    out = [convert.encode_translated_batch(bases, lengths, 120, m).tolist()
           for m in ("codon_id", "aa_id", "pc5_id", "murphy10_id",
                     "pc2_id", "dicodon_id")]
    out += [convert.encode_nucleotide_batch(bases, lengths, 120, None, oh,
                                            -1).tolist()
            for oh in (False, True)]
    out.append(convert.valid_codon_lengths(lengths, 120, True).tolist())
    out.append(convert._class_interleaved_permutation(
        rng.integers(0, 3, size=50), 4).tolist())
    return out


@pytest.mark.parametrize("name", sorted(_host_cases()))
def test_host_copy_matches_jax(name):
    call = _host_cases()[name]
    want = call("jaeger_tpu")
    got = call("jaeger_tpu_torch")
    assert repr(got) == repr(want)


# --- the utils commands ---------------------------------------------------------

def _write_csv(path, rng, n=24, classes=3, lo=150, hi=900):
    rows = [f"{int(rng.integers(0, classes))},{s}"
            for s in _seqs(rng, n, lo, hi, "ACGTN" if n > 20 else "ACGT")]
    path.write_text("\n".join(rows) + "\n")
    return path


def _write_fasta(path, rng, n=6, lo=3000, hi=9000, tandem=False):
    with open(path, "w") as fh:
        for i, s in enumerate(_seqs(rng, n, lo, hi)):
            if tandem and i == 1:
                s = s[:500] + "GATTACAGGC" * 20 + s[700:]
            fh.write(f">genome_{i}__class={i % 3} desc\n{s}\n")
    return path


def _write_predictions(path, rng, n=40):
    import pandas as pd

    classes = ["bacteria", "phage", "eukarya"]
    rows = []
    for i in range(n):
        scores = rng.dirichlet(np.ones(3))
        rows.append({
            "contig_id": f"c{i}", "length": int(rng.integers(2_000, 90_000)),
            "prediction": classes[int(np.argmax(scores))],
            "entropy": float(rng.uniform(0, 1.5)),
            "energy": float(rng.normal(-4, 1)),
            "reliability_score": float(rng.uniform(0, 1)),
            **{f"{c}_score": scores[j] for j, c in enumerate(classes)},
            **{f"{c}_var": rng.uniform(0.01, 0.2) for c in classes},
            **{f"{c}_windows": int(rng.integers(1, 30)) for c in classes},
        })
    pd.DataFrame(rows).to_csv(path, sep="\t", index=False)
    return path


def _ood_predictions(path, fasta):
    """A predictions TSV whose ids carry each record's true class; the
    first three records are predicted right."""
    from jaeger_tpu_torch.seqops.fasta import read_fasta

    classes = ["bacteria", "phage", "eukarya"]
    lines = ["contig_id\tlength\tprediction"]
    for i, (header, _) in enumerate(read_fasta(fasta)):
        predicted = classes[i % 3] if i < 3 else classes[(i + 1) % 3]
        lines.append(f"{header}__class={i % 3}\t5000\t{predicted}")
    path.write_text("\n".join(lines) + "\n")
    return path


def _fake_mmseqs(bin_dir):
    """An ``mmseqs`` on PATH: easy-cluster keeps every other record as a
    representative (the port passes the call through, as JAX does)."""
    bin_dir.mkdir()
    exe = bin_dir / "mmseqs"
    exe.write_text(
        "#!/usr/bin/env python3\n"
        "import sys\n"
        "fa, prefix = sys.argv[2], sys.argv[3]\n"
        "recs = open(fa).read().split('>')[1:]\n"
        "with open(prefix + '_rep_seq.fasta', 'w') as fh:\n"
        "    for r in recs[::2]:\n"
        "        fh.write('>' + r)\n")
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)


#: (case, argv with {in}/{out}/{fa}/{csv}/{pred}/{tsv} placeholders, the
#: outputs to compare, the input kind)
COMMAND_CASES = {
    "optimize-data-ragged": (
        ["utils", "optimize-data", "-i", "{csv}", "-o", "{out}/d.npz"],
        ["d.npz"]),
    "optimize-data-both-padded-balanced": (
        ["utils", "optimize-data", "-i", "{csv}", "-o", "{out}/d.npz",
         "--format", "both", "--pad", "--balance-classes", "--crop-size",
         "300", "--crop-size", "200", "--stride", "100", "--compress",
         "default", "--workers", "2"],
        ["d.npz"]),
    "optimize-data-codon-sharded-onehot": (
        ["utils", "optimize-data", "-i", "{csv}", "-o", "{out}/d.npz",
         "--format", "nucleotide", "--one-hot", "--units", "codon",
         "--crop-size", "60", "--overlap", "0.5", "--shard-size", "7",
         "--compress", "none"],
        ["d.npz"]),
    "fragment-csv": (
        ["utils", "fragment", "-i", "{fa}", "-o", "{out}/f.csv", "--fsize",
         "1000", "--stride", "700", "--label", "2"], ["f.csv"]),
    "fragment-fasta": (
        ["utils", "fragment", "-i", "{fa}", "-o", "{out}/f.fasta", "--fsize",
         "4000", "--min-len", "3500"], ["f.fasta"]),
    "fragment-random-lengths": (
        ["utils", "fragment", "-i", "{fa}", "-o", "{out}/f.fasta", "--minlen",
         "800", "--maxlen", "2000", "--overlap", "100", "--shuffle"],
        ["f.fasta"]),
    "mask-tandem": (
        ["utils", "mask-tandem", "-i", "{fa}", "-o", "{out}/m.fasta",
         "--workers", "2"], ["m.fasta"]),
    "mask-n": (
        ["utils", "mask", "-i", "{fa}", "-o", "{out}/m.fasta", "--maxperc",
         "0.05", "--step", "0.02", "--seed", "3"], ["m.fasta"]),
    "mask-mutate": (
        ["utils", "mask", "-i", "{fa}", "-o", "{out}/m.fasta", "--minperc",
         "0.01", "--maxperc", "0.04", "--step", "0.01", "--mutate",
         "--seed", "4"], ["m.fasta"]),
    "convert-fasta-to-csv": (
        ["utils", "convert", "-i", "{fa}", "-o", "{out}/c.csv", "--itype",
         "fasta"], ["c.csv"]),
    "convert-csv-to-fasta": (
        ["utils", "convert", "-i", "{csv3}", "-o", "{out}/c.fasta",
         "--itype", "CSV"], ["c.fasta"]),
    "stats-summary": (["utils", "stats", "-i", "{pred}"], []),
    "stats-pvals": (
        ["utils", "stats", "-i", "{pred}", "-o", "{out}/stats"],
        ["stats/jaeger_output_with_pvals.tsv"]),
    "split-seeded": (
        ["utils", "split", "-i", "{fa}", "-o", "{out}/s.fasta", "--minlen",
         "1000", "--maxlen", "3000", "--overlap", "50", "--seed", "8"],
        ["s.fasta"]),
    "split-coverage-circular-shuffled": (
        ["utils", "split", "-i", "{fa}", "-o", "{out}/s.fasta", "--minlen",
         "1500", "--maxlen", "2500", "--coverage", "1.5", "--circular",
         "--shuffle", "--seed", "9"], ["s.fasta"]),
    "ood-dinuc-tandem": (
        ["utils", "ood-data", "-i", "{fa}", "-o", "{out}/o.csv",
         "--num_tandem_repeats", "3", "--seed", "5"], ["o.csv"]),
    "ood-kmer-fasta-predictions": (
        ["utils", "ood-data", "-i", "{fa}", "-ip", "{oodpred}", "-o",
         "{out}/o.fasta", "--method", "kmer", "-k", "3", "--n-shuffles",
         "2", "--otype", "FASTA"], ["o.fasta"]),
    "ood-random-csv": (
        ["utils", "ood-data", "-i", "{csv}", "-o", "{out}/o.csv", "--method",
         "random", "--itype", "CSV", "--seq_col", "1"], ["o.csv"]),
    "dataset-minhash-ani": (
        ["utils", "dataset", "-i", "{fa}", "-o", "{out}/ds", "--fraglen",
         "1000", "--overlap", "500", "--class", "1", "--seed", "7"],
        ["ds_train.csv", "ds_val.csv", "ds_test.csv"]),
    "dataset-aai-fasta-out": (
        ["utils", "dataset", "-i", "{fa}", "-o", "{out}/ds", "--fraglen",
         "900", "--overlap", "300", "--method", "AAI", "--maxiden", "0.5",
         "--outtype", "FASTA", "--class", "2"],
        ["ds_train.fasta", "ds_val.fasta", "ds_test.fasta"]),
    "dataset-exact-csv-columns": (
        ["utils", "dataset", "-i", "{csv3}", "-o", "{out}/ds", "--fraglen",
         "300", "--overlap", "100", "--dedupe", "exact", "--intype", "CSV",
         "--seq_col", "1", "--class_col", "0"],
        ["ds_train.csv", "ds_val.csv", "ds_test.csv"]),
    "dataset-mmseqs": (
        ["utils", "dataset", "-i", "{fa}", "-o", "{out}/ds", "--fraglen",
         "1200", "--overlap", "400", "--mmseqs-bin", "mmseqs"],
        ["ds_train.csv", "ds_val.csv", "ds_test.csv"]),
    "receptive-field": (
        ["utils", "receptive_field", "-c",
         str(ROOT / "train_config" / "fragment_6class_variable_length.yaml")],
        []),
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("inputs")
    rng = np.random.default_rng(20261017)
    fa = _write_fasta(root / "genomes.fasta", rng, tandem=True)
    paths = {
        "fa": fa,
        "csv": _write_csv(root / "rows.csv", rng),
        "pred": _write_predictions(root / "pred.tsv", rng),
        "oodpred": _ood_predictions(root / "ood_pred.tsv", fa),
    }
    csv3 = root / "rows3.csv"
    csv3.write_text("".join(f"{int(rng.integers(0, 3))},{s},id{i}\n"
                            for i, s in enumerate(_seqs(rng, 12, 400, 1500))))
    paths["csv3"] = csv3
    _fake_mmseqs(root / "bin")
    paths["bin"] = root / "bin"
    return paths


def _argv(template, inputs, out):
    subst = {k: str(v) for k, v in inputs.items()}
    subst["out"] = str(out)
    return [a.format(**subst) for a in template]


def _same_npz(got, want):
    with np.load(want, allow_pickle=True) as a, \
            np.load(got, allow_pickle=True) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            x, y = a[key], b[key]
            assert x.dtype == y.dtype and x.shape == y.shape, key
            if x.dtype == object:
                for u, v in zip(x, y):
                    assert u.dtype == v.dtype
                    np.testing.assert_array_equal(v, u)
            else:
                np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("case", sorted(COMMAND_CASES))
def test_utils_command_matches_jax(case, inputs, tmp_path, monkeypatch):
    template, outputs = COMMAND_CASES[case]
    monkeypatch.setenv("PATH", f"{inputs['bin']}{os.pathsep}"
                               f"{os.environ['PATH']}")
    # the OOD shuffles draw from an unseeded default_rng in both packages:
    # give both runs the same seeded one
    real = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: real(1234 if seed is None else seed))
    runs = {}
    for name in ("jax", "torch"):
        out = tmp_path / name
        out.mkdir()
        argv = _argv(template, inputs, out)
        _reseed()
        if name == "jax":
            r = CliRunner().invoke(jcli.main, argv, catch_exceptions=False)
            assert r.exit_code == 0, r.output
            runs[name] = r.stdout
        else:
            import contextlib
            import io

            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main(argv)
            runs[name] = buf.getvalue()
    assert runs["torch"] == runs["jax"].replace(str(tmp_path / "jax"),
                                                str(tmp_path / "torch"))
    for rel in outputs:
        want, got = tmp_path / "jax" / rel, tmp_path / "torch" / rel
        assert want.exists() and want.stat().st_size > 0, rel
        if rel.endswith(".npz"):
            _same_npz(got, want)
        else:
            assert got.read_bytes() == want.read_bytes(), rel
    if case == "stats-pvals":
        pngs = {p.name for p in (tmp_path / "torch" / "stats").glob("*.png")}
        assert pngs == {p.name for p in
                        (tmp_path / "jax" / "stats").glob("*.png")}
        assert "class_percentages_pval.png" in pngs


@pytest.mark.parametrize("argv,msg", [
    (["utils", "fragment", "-i", "{fa}", "-o", "x", "--minlen", "5"],
     "--minlen and --maxlen must be given together"),
    (["utils", "ood-data", "-i", "{csv}", "-o", "x", "--itype", "csv"],
     "when --itype CSV is used, --seq_col must be provided"),
    (["utils", "dataset", "-i", "{csv}", "-o", "x", "--intype", "CSV",
      "--seq_col", "1"], "for CSV input, specify both --seq_col and "
                         "--class_col"),
    (["utils", "dataset", "-i", "{fa}", "-o", "x", "--intype", "FASTA"],
     "for FASTA input, specify --class"),
    (["utils", "optimize-data", "-i", "{csv}", "-o", "x", "--overlap", "2"],
     "--overlap 2.0: not in the range 0-1"),
    (["utils", "mask", "-i", "no_such.fasta", "-o", "x"], "does not exist"),
])
def test_utils_usage_errors(argv, msg, inputs, capsys, tmp_path):
    """The JAX commands' usage errors: exit 2 with the message."""
    argv = _argv(argv, inputs, tmp_path)
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 2
    assert msg in capsys.readouterr().err
    assert CliRunner().invoke(jcli.main, argv).exit_code == 2


@pytest.mark.parametrize("args", [
    ["--crop-size", "104"],
    ["--crop-size", "104", "--pad", "--dtype", "int32"],
    ["--crop-size", "59", "--shard-size", "10"],
])
def test_optimize_data_npz_reads_in_port_train(args, inputs, tmp_path):
    """The NPZ that ``utils optimize-data`` writes: the port's
    ``load_npz_dataset`` reads it as JAX's does, and the port's ``train``
    takes a step on it."""
    import yaml

    from jaeger_tpu.train.data import load_npz_dataset as jax_load
    from jaeger_tpu_torch.commands.train import train_fragment_core
    from jaeger_tpu_torch.train.data import load_npz_dataset

    npz = tmp_path / "d.npz"
    cli.main(["utils", "optimize-data", "-i", str(inputs["csv"]), "-o",
              str(npz), *args])
    got, want = load_npz_dataset(npz), jax_load(npz)
    assert sorted(got) == sorted(want)
    for key in want:
        if want[key].dtype == object:
            for u, v in zip(want[key], got[key]):
                np.testing.assert_array_equal(v, u)
        else:
            np.testing.assert_array_equal(got[key], want[key])

    cfg = yaml.safe_load((ROOT / "tests" / "data" /
                          "tiny_config.yaml").read_text())
    cfg["model"]["string_processor"]["data_format"] = "numpy"
    t = cfg["training"]
    t.update(classifier_train_steps=1, batch_size=8)
    t["fragment_classifier_data"] = {"train": [{
        "class": ["chromosome", "phage", "plasmid"], "path": [str(npz)],
        "label": [0, 1, 2]}]}
    t.pop("fragment_reliability_data", None)
    config = tmp_path / "config.yaml"
    config.write_text(yaml.safe_dump(cfg))
    results = train_fragment_core(config_path=str(config),
                                  output_dir=str(tmp_path / "run"),
                                  device="cpu")
    assert (Path(results["model_path"]) / "params.msgpack").exists()
    history = json.dumps(results.get("history", {}), default=str)
    assert "nan" not in history.lower()
