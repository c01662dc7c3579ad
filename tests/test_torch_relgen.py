"""The port's reliability-data generator and its ``train`` wiring against
jaeger_tpu's, on the CPU, in f32.

The three cases of ``tests/test_health_and_relgen.py`` (one chunk with a
0.2 / 0.99 threshold pair; 16-row chunks with the predictions CSV reused on
a rerun; a dedicated validation CSV with downsampling to the synthetic
count) run through both packages on the same tiny model (JAX's initial
weights carried across with ``params_from_jax``) and the same seeded raw
CSVs: ``reliability_train.csv`` and ``reliability_val.csv`` byte-identical,
every ``*_preds.csv`` with the same header, ids and labels and its logits
and probabilities within 1e-5 of their scale (the f32 forwards sum in other
orders; the CSV prints 7 significant digits). The perturbation specs,
counts and synthetic sequences equal JAX's from the same seed; and the
``train`` wiring of ``tests/test_train.py:473-555``: ``raw_csv_paths`` and
``output_dir`` honoured, configured reliability paths ignored with a
warning, the threshold options passed through the CLI, the
``ValueError`` without a raw CSV.
"""

import copy
import importlib.util
import logging
from pathlib import Path

import numpy as np
import pytest
import yaml

import jax

from jaeger_tpu.dataops import reliability_generator as jrg
from jaeger_tpu.models.builder import ModelBuilder
from jaeger_tpu_torch.dataops import reliability_generator as trg
from jaeger_tpu_torch.models.artifacts import load_state, params_from_jax
from jaeger_tpu_torch.models.builder import build_model

from tests.test_resume_e2e import _write_fixture


def _modern_tiny() -> dict:
    spec = importlib.util.spec_from_file_location(
        "tmc", Path(__file__).with_name("test_modern_convert.py"))
    tmc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tmc)
    return copy.deepcopy(tmc.CONFIG)


def _rg_config() -> dict:
    return {
        "model": {
            "name": "rg", "seed": 0, "classifier_out_dim": 3,
            "class_label_map": [
                {"class": "a", "label": 0}, {"class": "b", "label": 1},
                {"class": "c", "label": 2}],
            "embedding": {"use_embedding_layer": True,
                          "input_type": "translated", "embedding_size": 4},
            "string_processor": {"crop_size": 40, "seq_onehot": False},
            "representation_learner": {
                "hidden_layers": [
                    {"name": "masked_conv1d",
                     "config": {"filters": 4, "kernel_size": 3}}],
                "pooling": "average"},
            "classifier": {"hidden_layers": [
                {"name": "dense", "config": {"units": 3}}]},
        },
        "training": {},
    }


def _models(cfg):
    """JAX's model and initial variables, and the port's model with the same
    weights (f32, CPU, eval mode)."""
    b = ModelBuilder(copy.deepcopy(cfg))
    jm, jvars = b.init()
    tm = build_model(copy.deepcopy(cfg))
    load_state(tm, params_from_jax(jax.tree.map(np.asarray, jvars)))
    return jm, jvars, tm.eval(), b.crop[1]


def _write_csv(path, rng, n, length, pools=None):
    with open(path, "w") as fh:
        for i in range(n):
            alphabet = list(pools[i % 3]) if pools else list("ACGT")
            seq = "".join(rng.choice(alphabet, size=length))
            fh.write(f"{i % 3},{seq}\n")


def _same_outputs(jdir: Path, tdir: Path) -> None:
    for name in ("reliability_train.csv", "reliability_val.csv"):
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name
    preds = sorted(p.name for p in jdir.glob("*_preds.csv"))
    assert preds and preds == sorted(p.name for p in tdir.glob("*_preds.csv"))
    for name in preds:
        want = (jdir / name).read_text().splitlines()
        got = (tdir / name).read_text().splitlines()
        assert got[0] == want[0] and len(got) == len(want), name
        w = np.array([r.split(",") for r in want[1:]])
        g = np.array([r.split(",") for r in got[1:]])
        assert (g[:, :2] == w[:, :2]).all(), name
        wv, gv = w[:, 2:].astype(float), g[:, 2:].astype(float)
        scale = max(float(np.abs(wv).max()), 1e-6)
        np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=name)


def _run_both(tmp_path, cfg, raw, kw):
    jm, jvars, tm, crop_nt = _models(cfg)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jp = jrg.generate_reliability_data(jm, jvars, str(raw), str(jdir),
                                       crop_nt, **kw)
    tp = trg.generate_reliability_data(tm, str(raw), str(tdir), crop_nt,
                                       **kw)
    assert tp == {k: {**v, "paths": [p.replace(str(jdir), str(tdir))
                                     for p in v["paths"]]}
                  for k, v in jp.items()}
    _same_outputs(jdir, tdir)
    return jm, jvars, tm, crop_nt, jdir, tdir


def test_generator_outputs_match_jax(tmp_path, rng):
    """``test_reliability_generator_outputs``: id 0.2, synthetic 0.99,
    batch 32, seed 0; then the idempotent second call."""
    raw = tmp_path / "raw.csv"
    _write_csv(raw, rng, 90, 200,
               {0: "ATGCATGC", 1: "GGGGCCCCATGC", 2: "AAAATTTTATGC"})
    *_, tm, crop_nt, jdir, tdir = _run_both(
        tmp_path, _modern_tiny(), raw,
        dict(id_threshold=0.2, synthetic_ood_threshold=0.99, batch_size=32,
             seed=0))
    rows = (tdir / "reliability_train.csv").read_text().splitlines()
    assert len(rows) > 10 and {r[0] for r in rows} <= {"0", "1"}
    again = trg.generate_reliability_data(tm, str(raw), str(tdir), crop_nt)
    assert again["train"]["paths"] == [str(tdir / "reliability_train.csv")]


def test_generator_chunked_streaming_matches_jax(tmp_path, rng):
    """``test_reliability_generator_chunked_streaming``: 16-row chunks,
    thresholds 0, batch 8, seed 3; a rerun with the reliability CSVs gone
    reuses the predictions CSV (left untouched) and writes the same
    bytes."""
    import os

    raw = tmp_path / "raw.csv"
    _write_csv(raw, rng, 60, 150)
    kw = dict(id_threshold=0.0, synthetic_ood_threshold=0.0, chunk_size=16,
              seed=3, batch_size=8)
    *_, tm, crop_nt, jdir, tdir = _run_both(tmp_path, _rg_config(), raw, kw)
    train = (tdir / "reliability_train.csv").read_text().splitlines()
    val = (tdir / "reliability_val.csv").read_text().splitlines()
    assert len(train) + len(val) == 120
    preds = (tdir / "raw_preds.csv").read_text().splitlines()
    assert preds[0] == ("seq_id,label,logit_0,logit_1,logit_2,"
                        "prob_0,prob_1,prob_2")
    assert len(preds) == 61 and preds[1].split(",")[0] == "0"
    t0 = (tdir / "reliability_train.csv").read_bytes()
    os.unlink(tdir / "reliability_train.csv")
    os.unlink(tdir / "reliability_val.csv")
    mtime = os.path.getmtime(tdir / "raw_preds.csv")
    trg.generate_reliability_data(tm, str(raw), str(tdir), crop_nt, **kw)
    assert (tdir / "reliability_train.csv").read_bytes() == t0
    assert os.path.getmtime(tdir / "raw_preds.csv") == mtime
    assert trg._num_classes(tm, crop_nt) == 3


def test_generator_balancing_and_val_csv_match_jax(tmp_path, rng):
    """``test_reliability_generator_balancing_and_val_csv``: a dedicated
    validation CSV, multiplier 0.5, seed 5, batch 16; real rows
    downsampled to the synthetic count."""
    raw, raw_val = tmp_path / "raw.csv", tmp_path / "rawval.csv"
    _write_csv(raw, rng, 60, 180)
    _write_csv(raw_val, rng, 20, 180)
    *_, jdir, tdir = _run_both(
        tmp_path, _modern_tiny(), raw,
        dict(id_threshold=0.0, synthetic_ood_threshold=0.0,
             synthetic_ood_multiplier=0.5, seed=5, batch_size=16,
             raw_val_csv_path=str(raw_val)))
    assert len((tdir / "reliability_train.csv").read_text()
               .splitlines()) == 60
    assert len((tdir / "reliability_val.csv").read_text()
               .splitlines()) == 20
    assert (tdir / "rawval_preds.csv").exists()


def test_predict_rows_match_jax(rng):
    """``_predict_csv_rows`` on rows shorter and longer than the crop, with
    a batch that does not divide them: predictions equal, confidences and
    logits to 1e-5."""
    jm, jvars, tm, crop_nt = _models(_modern_tiny())
    rows = [(i % 3, "".join(rng.choice(list("ACGTN"), size=int(n))))
            for i, n in enumerate(rng.integers(20, 260, size=23))]
    jp, jc, jl, jpr = jrg._predict_csv_rows(jm, jvars, rows, crop_nt, 8,
                                            return_logits=True)
    tp, tc, tl, tpr = trg._predict_csv_rows(tm, rows, crop_nt, 8,
                                            return_logits=True)
    assert (tp == jp).all()
    for got, want in ((tc, jc), (tl, jl), (tpr, jpr)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


PERTURBATIONS = [
    None,
    {"shuffle": {"enabled": True, "mode": "dinuc"},
     "subseq_repeat": {"enabled": True, "window_fraction": 0.25},
     "tandem_repeat": {"enabled": True, "motif_length_range": [3, 10],
                       "window_fraction": 0.25, "num_repeats": 20},
     "mix": True},
    {"shuffle": {"mode": ["random", "dinuc"]}, "subseq_repeat": False,
     "tandem_repeat": {"count": 5},
     "n_stretch": {"n_fraction_range": [0.2, 0.4], "multiplier": 0.5}},
    {"shuffle": False, "subseq_repeat": {"multiplier": 0.25},
     "tandem_repeat": False, "mix": {"n_segments": 3}},
]


@pytest.mark.parametrize("case", range(len(PERTURBATIONS)))
def test_perturbation_specs_counts_and_sequences_match_jax(case,
                                                           random_dna):
    cfg = PERTURBATIONS[case]
    want = jrg.normalize_perturbations(copy.deepcopy(cfg))
    got = trg.normalize_perturbations(copy.deepcopy(cfg))
    strip = [{k: v for k, v in s.items() if k != "fn"} for s in want]
    assert [{k: v for k, v in s.items() if k != "fn"} for s in got] == strip
    assert [getattr(s["fn"], "__name__", None) for s in got] == \
        [getattr(s["fn"], "__name__", None) for s in want]
    rows = [(i % 3, random_dna(300)) for i in range(14)]
    for mult in (0.0, 0.5, 1.0, 2.3):
        assert trg.compute_perturbation_counts(rows, mult, got, cfg or {}) \
            == jrg.compute_perturbation_counts(rows, mult, want, cfg or {})
    kw = dict(perturbations=copy.deepcopy(cfg), crop_size=150, seed=11,
              generation_chunk_size=7)
    assert trg.generate_synthetic_sequences(rows, 1.5, **kw) == \
        jrg.generate_synthetic_sequences(rows, 1.5, **kw)


def test_sampling_helpers_match_jax(random_dna):
    rows = [(i % 4, random_dna(50)) for i in range(37)]
    synth = [(0, random_dna(50)) for _ in range(13)]
    assert trg.downsample_to_match(rows, synth, np.random.default_rng(2)) \
        == jrg.downsample_to_match(rows, synth, np.random.default_rng(2))
    assert trg.sample_records_for_synthetic_generation(
        rows, 9, np.random.default_rng(4)) == \
        jrg.sample_records_for_synthetic_generation(
            rows, 9, np.random.default_rng(4))
    assert trg.prediction_csv_header(4) == jrg.prediction_csv_header(4)


def _wiring_config(tmp_path, rng) -> tuple[Path, dict]:
    cfg_path = _write_fixture(tmp_path, rng)
    cfg = yaml.safe_load(cfg_path.read_text())
    cfg["model"]["reliability_model"] = {
        "mode": "nmd",
        "hidden_layers": [{"name": "dense",
                           "config": {"units": 1, "dtype": "float32"}}],
    }
    t = cfg["training"]
    t.update(classifier_epochs=1, classifier_train_steps=2,
             reliability_epochs=1, reliability_train_steps=2,
             loss_reliability="binary_crossentropy")
    return cfg_path, cfg


def test_train_wiring_honours_the_generation_config(tmp_path, rng, caplog):
    """The port's ``train_fragment_core`` with ``generate_reliability``:
    no NMD tap raises the reference's error; ``raw_csv_paths`` and
    ``output_dir`` are honoured, configured reliability paths ignored with
    a warning, and the reliability branch trains on the generated rows;
    the threshold options reach the generator through the CLI."""
    from jaeger_tpu_torch import cli
    from jaeger_tpu_torch.commands.train import train_fragment_core

    cfg_path, cfg = _wiring_config(tmp_path, rng)
    cfg_path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    with pytest.raises(ValueError, match="produced no NMD tensor"):
        train_fragment_core(str(cfg_path), str(tmp_path / "m0"),
                            device="cpu", save=False,
                            generate_reliability=True)

    cfg["model"]["representation_learner"]["hidden_layers"].append(
        {"name": "masked_batchnorm", "config": {"return_nmd": True}})
    raw_train, raw_val = tmp_path / "raw_train.csv", tmp_path / "raw_val.csv"
    _write_csv(raw_train, rng, 40, 100)
    _write_csv(raw_val, rng, 12, 100)
    gen_out = tmp_path / "relgen_custom"
    cfg["training"]["reliability_data_generation"] = {
        "raw_csv_paths": {"train": str(raw_train), "val": str(raw_val)},
        "output_dir": str(gen_out), "id_threshold": 0.0,
        "synthetic_ood_threshold": 0.0, "synthetic_ood_multiplier": 0.5,
        "inference_batch_size": 16,
    }
    cfg["training"]["fragment_reliability_data"] = {
        "train": [{"class": ["x"], "path": [str(raw_train)], "label": [0]}]}
    cfg_path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    with caplog.at_level(logging.WARNING, logger="jaeger_tpu_torch"):
        r = train_fragment_core(str(cfg_path), str(tmp_path / "m1"),
                                device="cpu", save=False,
                                generate_reliability=True)
    assert any("ignoring" in rec.message and "fragment_reliability_data"
               in rec.message for rec in caplog.records)
    assert r["history"]["reliability"]
    for name in ("reliability_train.csv", "reliability_val.csv",
                 "raw_train_preds.csv", "raw_val_preds.csv"):
        assert (gen_out / name).exists(), name
    # 40 real rows downsampled to 20 synthetic, plus the 20
    assert len((gen_out / "reliability_train.csv").read_text()
               .splitlines()) == 40

    # the CLI's thresholds override the config's: an id threshold above
    # any softmax confidence keeps no real row, a multiplier of 1.0 gives
    # 40 synthetic rows, all kept at a synthetic threshold of 0
    cfg["training"]["reliability_data_generation"]["output_dir"] = str(
        tmp_path / "relgen_cli")
    cfg_path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    cli.main(["train", "-c", str(cfg_path), "-o", str(tmp_path / "m2"),
              "--device", "cpu", "--generate-reliability-data",
              "--id-threshold", "1.01", "--synthetic_ood_threshold", "0",
              "--synthetic-ood-multiplier", "1.0"])
    rows = (tmp_path / "relgen_cli" / "reliability_train.csv").read_text() \
        .splitlines()
    assert len(rows) == 40 and {r[0] for r in rows} == {"0"}


def test_train_wiring_without_a_raw_csv_raises(tmp_path, rng):
    from jaeger_tpu_torch.commands.train import train_fragment_core

    cfg_path, cfg = _wiring_config(tmp_path, rng)
    cfg["model"]["representation_learner"]["hidden_layers"].append(
        {"name": "masked_batchnorm", "config": {"return_nmd": True}})
    cfg["training"]["reliability_data_generation"] = {}
    cfg["training"]["fragment_classifier_data"] = {}
    cfg["training"]["classifier_epochs"] = 0
    cfg_path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    with pytest.raises(ValueError, match="raw_csv_paths.train"):
        train_fragment_core(str(cfg_path), str(tmp_path / "m"),
                            device="cpu", save=False,
                            generate_reliability=True)


def test_train_generates_the_same_reliability_data_as_jax(tmp_path, rng):
    """The slice end to end: ``train_fragment_core`` with
    ``generate_reliability`` in both packages on the same config, raw CSV
    and seed (classifier training first, then generation, then the
    reliability branch). The two packages draw their initial weights from
    different generators, so their classifiers differ: an id threshold
    above any softmax confidence keeps no real row and a synthetic
    threshold of 0 keeps every synthetic one, which makes the rows
    independent of the classifier. The reliability CSVs are then
    byte-identical: the same synthetic sequences, shuffle and split."""
    from jaeger_tpu.commands.train import train_fragment_core as jtrain
    from jaeger_tpu_torch.commands.train import train_fragment_core

    cfg_path, cfg = _wiring_config(tmp_path, rng)
    cfg["model"]["representation_learner"]["hidden_layers"].append(
        {"name": "masked_batchnorm", "config": {"return_nmd": True}})
    cfg["training"]["reliability_data_generation"] = {
        "id_threshold": 1.01, "synthetic_ood_threshold": 0.0,
        "synthetic_ood_multiplier": 0.5, "inference_batch_size": 32}
    cfg_path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    rj = jtrain(str(cfg_path), output_dir=str(tmp_path / "jax"),
                use_mesh=False, save=False, generate_reliability=True)
    rt = train_fragment_core(str(cfg_path), str(tmp_path / "torch"),
                             device="cpu", save=False,
                             generate_reliability=True)
    assert rj["history"]["reliability"] and rt["history"]["reliability"]
    rows = 0
    for name in ("reliability_train.csv", "reliability_val.csv"):
        got = (tmp_path / "torch" / "reliability_data" / name).read_bytes()
        assert got == (tmp_path / "jax" / "reliability_data" / name) \
            .read_bytes()
        rows += got.count(b"\n")
    assert rows == 45
