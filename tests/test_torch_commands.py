"""The port's ``health``, model registry, ``download``, ``taxonomy`` and
``predict`` device flags against `jaeger_tpu` on the CPU.

Tolerances. The tiny model's f32 forward: 1e-5 of the output's scale (the
two packages sum the convolutions in different orders). The taxonomy
index: the normalized embeddings within 1e-5, the taxids exactly, and the
TSV byte for byte (``mean_knn_similarity`` is written with ``%.4f``).
"""

import io
import json
import logging
import tarfile
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from jaeger_tpu_torch import cli

ROOT = Path(__file__).resolve().parent.parent
FASTA = ROOT / "jaeger_tpu" / "data" / "test" / "test_contigs.fasta"
DEMO = ROOT / "jaeger_tpu" / "data" / "models" / "demo"

#: the fixture model of tests/test_e2e_commands.py
E2E_CONFIG = {
    "model": {
        "name": "e2e_tiny",
        "seed": 3,
        "classifier_out_dim": 3,
        "class_label_map": [
            {"class": "chromosome", "label": 0},
            {"class": "phage", "label": 1},
            {"class": "plasmid", "label": 2},
        ],
        "embedding": {"use_embedding_layer": True,
                      "input_type": "translated", "embedding_size": 8},
        "string_processor": {"crop_size": 60, "seq_onehot": False},
        "representation_learner": {
            "hidden_layers": [
                {"name": "masked_conv1d",
                 "config": {"filters": 8, "kernel_size": 3}},
                {"name": "masked_batchnorm", "config": {"return_nmd": True}},
                {"name": "gelu"},
            ],
            "pooling": "average",
        },
        "reliability_model": {
            "mode": "nmd",
            "hidden_layers": [{"name": "dense", "config": {"units": 1}}],
        },
        "classifier": {
            "hidden_layers": [{"name": "dense", "config": {"units": 3}}],
        },
    },
    "training": {},
}


@pytest.fixture(autouse=True)
def _own_registry(tmp_path, monkeypatch):
    """The default registry file of both packages inside the test."""
    monkeypatch.setenv("JAEGER_TPU_HOME", str(tmp_path / "home"))


@pytest.fixture(scope="module")
def e2e_bundle(tmp_path_factory):
    from jaeger_tpu.models.artifacts import save_model
    from jaeger_tpu.models.builder import ModelBuilder

    _, variables = ModelBuilder(E2E_CONFIG).init()
    path = tmp_path_factory.mktemp("bundle") / "model"
    save_model(variables, E2E_CONFIG, path)
    return path


def _run(argv):
    """``cli.main(argv)`` -> exit code (0 when it returns)."""
    try:
        cli.main([str(a) for a in argv])
    except SystemExit as e:
        return e.code if isinstance(e.code, int) else 1
    return 0


# --- health -------------------------------------------------------------------

def test_health_core_on_cpu(capsys):
    from jaeger_tpu_torch.commands.health import health_core

    assert health_core(device="cpu") == 0
    out = capsys.readouterr().out
    for name in ("device matmul", "fasta validation", "device codon encode",
                 "model save/load/predict round trip"):
        assert f"  [ok] {name}" in out
    assert "test_contigs.fasta:9/9 test_short.fasta:0/1" in out
    assert out.rstrip().endswith("health: OK")
    assert f"torch    : {torch.__version__}" in out
    assert "native   : " in out


def test_health_without_cuda_fails(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert _run(["health"]) == 1
    out = capsys.readouterr().out
    assert "  device   : no CUDA device" in out
    assert "  [FAIL] device matmul: " in out
    assert "  [ok] fasta validation" in out
    assert out.rstrip().endswith("health: 3 FAILURES")


def test_health_tiny_model_matches_jax(tmp_path):
    """The tiny model's forward against JAX's in f32, JAX's weights carried
    by ``params_from_jax``; and the port's own round trip loads in JAX."""
    from jaeger_tpu.commands.health import _TINY_CONFIG as JAX_TINY
    from jaeger_tpu.models.artifacts import load_model as jax_load_model
    from jaeger_tpu.models.builder import ModelBuilder
    from jaeger_tpu_torch.commands.health import _TINY_CONFIG, tiny_roundtrip
    from jaeger_tpu_torch.models.artifacts import load_state, params_from_jax
    from jaeger_tpu_torch.models.builder import build_model

    assert _TINY_CONFIG == JAX_TINY
    model, variables = ModelBuilder(JAX_TINY).init()
    rng = np.random.default_rng(0)
    bases = rng.integers(0, 4, size=(4, 305), dtype=np.uint8)
    lengths = np.full(4, 305, np.int32)
    want = np.asarray(model.apply(
        variables, {"bases": bases, "lengths": lengths},
        train=False)["prediction"])
    port = build_model(_TINY_CONFIG)
    load_state(port, params_from_jax(variables))
    with torch.inference_mode():
        got = port.eval()(torch.from_numpy(bases),
                          torch.from_numpy(lengths))["prediction"].numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)

    out, classes = tiny_roundtrip(tmp_path / "tiny", device="cpu")
    assert tuple(out["prediction"].shape) == (4, 3)
    assert classes == {0: "chromosome", 1: "phage", 2: "plasmid"}
    jmodel, jvars, _, _ = jax_load_model(tmp_path / "tiny")
    jout = np.asarray(jmodel.apply(
        jvars, {"bases": bases, "lengths": lengths}, train=False)["prediction"])
    np.testing.assert_allclose(out["prediction"].numpy(), jout, rtol=0,
                               atol=1e-5 * np.abs(jout).max())


# --- the registry -------------------------------------------------------------

def test_registry_register_list_resolve(tmp_path, capsys, e2e_bundle):
    """register-models / list-models, the names predict -m takes, and a
    registry shared by both packages."""
    from jaeger_tpu.commands.predict import (
        resolve_model_path as jax_resolve)
    from jaeger_tpu.utils import registry as jreg
    from jaeger_tpu_torch.commands.predict import resolve_model_path
    from jaeger_tpu_torch.utils import registry

    reg = tmp_path / "reg.json"
    assert _run(["list-models", "--config", reg]) == 0
    assert capsys.readouterr().out == "no models registered\n"
    assert _run(["register-models", "-p", e2e_bundle, "-c", reg]) == 0
    assert capsys.readouterr().out == "registered; 1 model path(s) known\n"
    assert _run(["register-models", e2e_bundle, "--registry", reg]) == 0
    assert capsys.readouterr().out == "registered; 1 model path(s) known\n"
    assert _run(["list-models", "--registry", reg]) == 0
    assert capsys.readouterr().out == f"e2e_tiny\t{e2e_bundle}\n"
    assert reg.read_text() == json.dumps(
        {"model_paths": [str(e2e_bundle.resolve())]}, indent=2)

    for name in (None, str(e2e_bundle), "e2e_tiny"):
        got = resolve_model_path(name, registry_path=str(reg))
        want = jax_resolve(name, registry_path=str(reg))
        assert Path(got).resolve() == Path(want).resolve()
    with pytest.raises(FileNotFoundError) as port_err:
        resolve_model_path("missing", registry_path=str(reg))
    with pytest.raises(FileNotFoundError) as jax_err:
        jax_resolve("missing", registry_path=str(reg))
    assert str(port_err.value) == str(jax_err.value)

    # the default registry file, written by one package, read by the other
    jreg.add_to_registry(e2e_bundle)
    assert registry.default_registry_path() == jreg.default_registry_path()
    assert registry.AvailableModels().resolve("e2e_tiny") == str(e2e_bundle)
    assert registry.load_registry() == jreg.load_registry()

    # usage errors
    assert _run(["register-models", "-c", reg]) == 2
    assert "provide a model path (-p/--path)" in capsys.readouterr().err
    assert _run(["register-models", tmp_path / "nowhere"]) == 2
    assert "does not exist" in capsys.readouterr().err


def test_predict_registered_name(tmp_path, capsys):
    """predict -m <registered name> --config <registry> writes the TSV of
    predict -m <path>; an unknown name is an error naming the known ones."""
    reg = tmp_path / "reg.json"
    assert _run(["register-models", "-p", DEMO, "-c", reg]) == 0
    name = yaml.safe_load((DEMO / "project.yaml").read_text())["model"]["name"]
    common = ["-i", FASTA, "--device", "cpu", "--precision", "float32",
              "--workers", "1"]
    assert _run(["predict", "-o", tmp_path / "by_path", "-m", DEMO,
                 *common]) == 0
    assert _run(["predict", "-o", tmp_path / "by_name", "-m", name,
                 "--config", reg, *common]) == 0
    tsv = "test_contigs_default_jaeger.tsv"
    assert ((tmp_path / "by_name" / tsv).read_bytes()
            == (tmp_path / "by_path" / tsv).read_bytes())
    capsys.readouterr()
    assert _run(["predict", "-o", tmp_path / "x", "-m", "no_such_model",
                 "--config", reg, *common]) == 1
    assert (f"Error: model 'no_such_model' not found; known: ['{name}']"
            in capsys.readouterr().err)


def _model_tar() -> bytes:
    buf = io.BytesIO()
    project = yaml.safe_dump({"model": {"name": "jaeger_test_1.4M",
                                        "classifier_out_dim": 2}})
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        for name, data in (("bundle/params.msgpack", b"\x81\xa6params\x80"),
                           ("bundle/project.yaml", project.encode()),
                           ("bundle/classes.yaml", b"0: a\n1: b\n")):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return buf.getvalue()


@pytest.fixture()
def catalog_server():
    """A CKAN ``package_search`` answer and a model tarball, served from a
    local HTTP server."""
    tar_bytes = _model_tar()

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.startswith("/api"):
                url = (f"http://127.0.0.1:{self.server.server_port}"
                       f"/models/jaeger_test.tar.gz")
                body = json.dumps({"success": True, "result": {"results": [{
                    "name": "jaeger-models", "resources": [
                        {"name": "jaeger_test_1.4M", "id": "r1", "url": url},
                        {"name": "readme", "id": "r2", "url": ""}]}]}}
                ).encode()
                ctype = "application/json"
            elif self.path.endswith(".tar.gz"):
                body, ctype = tar_bytes, "application/gzip"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_port}"
    finally:
        srv.shutdown()
        thread.join(timeout=5)


def test_download_from_local_server(tmp_path, capsys, monkeypatch,
                                    catalog_server):
    """download URL, download -m NAME and download --list against a local
    catalog; the port's catalog parse equals JAX's."""
    from jaeger_tpu.utils import registry as jreg
    from jaeger_tpu_torch.utils import registry

    api = f"{catalog_server}/api/3/action/package_search"
    links = registry.list_model_catalog(api_url=api)
    assert links == jreg.list_model_catalog(api_url=api)
    reg = tmp_path / "reg.json"
    url = links["jaeger_test_1.4M"]
    assert _run(["download", url, "-p", tmp_path / "a", "-c", reg]) == 0
    assert capsys.readouterr().out == "registered 1 model(s)\n"
    assert (registry.AvailableModels(registry_path=reg)
            .resolve("jaeger_test_1.4M") == str(tmp_path / "a" / "bundle"))

    real = registry.list_model_catalog
    monkeypatch.setattr(registry, "list_model_catalog",
                        lambda: real(api_url=api))
    assert _run(["download", "--list"]) == 0
    assert capsys.readouterr().out == f"- jaeger_test_1.4M\t{url}\n"
    assert _run(["download", "-m", "jaeger_test_1.4M", "-d", tmp_path / "b",
                 "--registry", reg]) == 0
    assert capsys.readouterr().out == "registered 1 model(s)\n"
    assert (tmp_path / "b" / "jaeger_models" / "bundle"
            / "params.msgpack").exists()
    assert len(json.loads(reg.read_text())["model_paths"]) == 2

    for argv, msg in (
            (["download", "--list", url],
             "the '--list' option cannot be used with a model or URL"),
            (["download", "-m", "nope"],
             "model 'nope' not found; use '--list' to see available models"),
            (["download"],
             "provide a URL or -m MODEL_NAME, or --list for the catalog")):
        assert _run(argv) == 2
        assert msg in capsys.readouterr().err
    assert _run(["download", f"{catalog_server}/missing.tar", "-p",
                 tmp_path / "c", "-c", reg]) == 1
    assert ("Error: download failed (HTTP Error 404" in
            capsys.readouterr().err)


# --- taxonomy -----------------------------------------------------------------

def _taxonomy_fixture(tmp_path):
    """tests/test_e2e_commands.py's fixture: two 900 nt contigs of one
    species."""
    rng = np.random.default_rng(42)
    fasta = tmp_path / "refs.fasta"
    with open(fasta, "w") as fh:
        for i, n in enumerate([900, 900]):
            fh.write(f">ctg{i}\n{''.join(rng.choice(list('ATGC'), size=n))}\n")
    dump = tmp_path / "taxdump"
    dump.mkdir()
    (dump / "nodes.dmp").write_text(
        "1\t|\t1\t|\tno rank\t|\n2\t|\t1\t|\tsuperkingdom\t|\n"
        "3\t|\t2\t|\tspecies\t|\n")
    (dump / "names.dmp").write_text(
        "1\t|\troot\t|\t\t|\tscientific name\t|\n"
        "2\t|\tBacteria\t|\t\t|\tscientific name\t|\n"
        "3\t|\tE.coli\t|\t\t|\tscientific name\t|\n")
    (tmp_path / "acc2taxid.tsv").write_text("ctg0\t3\nctg1\t3\n")
    return fasta, dump, tmp_path / "acc2taxid.tsv"


def test_taxonomy_build_predict_matches_jax(tmp_path, e2e_bundle):
    """build + predict in f32: the index within 1e-5 of JAX's, the taxids
    exactly, the staged taxdump and taxdb.json equal, the TSV byte for
    byte; the CLI writes the same TSV."""
    from jaeger_tpu.commands import taxonomy as jtax
    from jaeger_tpu_torch.commands import taxonomy as ttax

    fasta, dump, acc = _taxonomy_fixture(tmp_path)
    kw = dict(fsize=400, batch=8, precision="float32")
    outs = {}
    for name, mod, extra in (("jax", jtax, {}),
                             ("torch", ttax, {"device": "cpu"})):
        db = mod.build_taxdb(str(e2e_bundle), str(fasta), str(acc),
                             str(dump), str(tmp_path / f"db_{name}"),
                             **kw, **extra)
        outs[name] = mod.predict_taxonomy(
            str(e2e_bundle), str(db), str(fasta),
            str(tmp_path / f"tax_{name}.tsv"), **kw, **extra)
    with np.load(tmp_path / "db_jax" / "genomes_index.npz") as a, \
            np.load(tmp_path / "db_torch" / "genomes_index.npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["embeddings", "taxids"]
        assert a["embeddings"].shape == b["embeddings"].shape == (4, 8)
        assert b["embeddings"].dtype == np.float32
        np.testing.assert_allclose(b["embeddings"], a["embeddings"],
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(b["taxids"], a["taxids"])
    for rel in ("tax/nodes.dmp", "tax/names.dmp", "taxdb.json"):
        assert ((tmp_path / "db_torch" / rel).read_bytes()
                == (tmp_path / "db_jax" / rel).read_bytes())
    want = outs["jax"].read_bytes()
    assert want.count(b"\n") == 3
    assert outs["torch"].read_bytes() == want

    assert _run(["taxonomy", "predict", "-m", e2e_bundle, "-d",
                 tmp_path / "db_torch", "-i", fasta, "-o",
                 tmp_path / "cli.tsv", "--fsize", "400", "--batch", "8",
                 "--precision", "float32", "--cpu"]) == 0
    assert (tmp_path / "cli.tsv").read_bytes() == want
    # an existing output needs -f, as in JAX
    with pytest.raises(SystemExit, match="already exists"):
        ttax.predict_taxonomy(str(e2e_bundle), str(tmp_path / "db_torch"),
                              str(fasta), str(tmp_path / "cli.tsv"),
                              device="cpu", **kw)


@pytest.mark.parametrize("case", ["duplicated_rows", "tied_kth", "all_equal",
                                  "chunked"])
def test_search_ties_go_to_the_lower_row(case, monkeypatch):
    """Equal scores rank the lower index row first, and a tie at the k-th
    score keeps the lowest rows: JAX's ``lax.top_k`` order, on duplicated
    index rows."""
    from jaeger_tpu.commands import taxonomy as jtax
    from jaeger_tpu_torch.commands import taxonomy as ttax

    rng = np.random.default_rng(7)
    index = rng.normal(size=(40, 8)).astype(np.float32)
    if case == "all_equal":
        index[:] = index[0]
    else:
        for dup in (9, 17, 33, 38):          # four copies of row 2
            index[dup] = index[2]
        index[25] = index[11]
    queries = np.concatenate([index[[2, 11, 38]],
                              rng.normal(size=(9, 8)).astype(np.float32)])
    k = {"tied_kth": 3}.get(case, 5)
    if case == "chunked":
        monkeypatch.setattr(ttax, "SEARCH_CHUNK_ELEMENTS", 40 * 5)
    taxids = np.arange(1, 41)
    s_t, i_t = ttax.CosineIndex(index, taxids).search(queries, k=k,
                                                      device="cpu")
    s_j, i_j = jtax.CosineIndex(index, taxids).search(queries, k=k)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=1e-6)
    if case == "all_equal":
        assert (i_t == np.arange(k)).all()
    else:
        assert list(i_t[0]) == [2, 9, 17, 33, 38][:k]
        assert list(i_t[1][:2]) == [11, 25]


# --- predict's device flags ---------------------------------------------------

@pytest.mark.parametrize("argv,code,msg", [
    (["--onnx"], 2, "--onnx: the engine zoo is replaced by a single XLA path "
                    "here (see docs/optimizations.md); use --quantized "
                    "full_int8 for the int8 bundle."),
    (["--devices", "many"], 2, "--devices 'many': 'auto' or an integer"),
    (["--physicalid", "7"], 2, "--physicalid 7: only"),
    (["--config", "no_such_registry.json"], 2, "no such file"),
])
def test_predict_flag_usage_errors(tmp_path, capsys, argv, code, msg):
    rc = _run(["predict", "-i", FASTA, "-o", tmp_path, *argv])
    assert rc == code
    assert msg in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


def test_predict_device_flags_run(tmp_path, caplog):
    """--cpu selects the CPU (the TSV of --device cpu); --devices 1 and
    auto, --mem and --xla are accepted, the last two logged as ignored."""
    common = ["-i", FASTA, "--precision", "float32", "--workers", "1"]
    assert _run(["predict", "-o", tmp_path / "dev", "--device", "cpu",
                 *common]) == 0
    with caplog.at_level(logging.INFO, logger="jaeger_tpu_torch"):
        assert _run(["predict", "-o", tmp_path / "flag", "--cpu", "--devices",
                     "1", *common]) == 0
    tsv = "test_contigs_default_jaeger.tsv"
    assert ((tmp_path / "flag" / tsv).read_bytes()
            == (tmp_path / "dev" / tsv).read_bytes())
    args = argparse_namespace(mem=8, xla=True)
    with caplog.at_level(logging.INFO, logger="jaeger_tpu_torch"):
        assert cli._device_from_flags(args, None) == "cuda"
    assert "--xla: there is no JIT step here; ignored" in caplog.text
    assert "--mem: device memory is managed by PyTorch's allocator" in (
        caplog.text)


def argparse_namespace(**kw):
    import argparse

    base = dict(cpu=False, physicalid=0, mem=4, xla=False, device="cuda")
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("command,argv", [
    ("convert-weights", ["-i", "weights.h5", "-o", "out"]),
    ("convert-graph", ["-m", "model", "-o", "out.stablehlo"])])
def test_converters_refused(capsys, command, argv):
    assert _run(["utils", command, *argv]) == 2
    assert (f"utils {command} is not yet ported to jaeger_tpu_torch "
            f"(ROADMAP.md queue 1, item 13)") in capsys.readouterr().err
