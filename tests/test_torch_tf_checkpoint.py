"""The port's TFRecord and TF-checkpoint readers against `jaeger_tpu`, on
the CPU.

* ``train/tfrecord.py``: records the port writes equal JAX's byte for
  byte, each package reads the other's, the CRC32C and its mask agree, and
  a flipped payload byte raises in both;
* ``models/tf_checkpoint.py`` on a SavedModel that TensorFlow writes (in a
  subprocess, once for the module) from the shipped ``WRes_1024.h5``
  weights, under the Keras layer names that ``_assemble_wres`` asks for
  (``aa``, ``block1_0``, ``bn_block1_1``, ``augdense-1``, ``outdense``,
  ...): the index entries and ``load_checkpoint`` equal JAX's key for key
  and array for array (the object graph is a string tensor, so its
  framing is read too);
* ``convert_wres_checkpoint`` equals JAX's tree and ``convert_wres_h5`` of
  the same ``.h5``; ``utils convert-weights -i <SavedModel>`` writes
  ``params.msgpack`` and ``legacy.yaml`` byte-identical to JAX's command;
* ``predict-legacy --model-dir <SavedModel> --device cpu`` through the
  port's CLI writes TSVs byte-identical to JAX's ``run_core`` on the same
  directory;
* TensorFlow writes its bundle index uncompressed, so the snappy route is
  held on hand-made streams (literals of every length form, copies with
  1-, 2- and 4-byte offsets, overlapping copies) and a block whose
  trailer names snappy, against JAX's decoder and the plain bytes.
"""

import os
import struct
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from jaeger_tpu.commands import predict_legacy as jpl
from jaeger_tpu.models import legacy_convert as jlc
from jaeger_tpu.models import tf_checkpoint as jck
from jaeger_tpu.train import tfrecord as jtf
from jaeger_tpu_torch import cli
from jaeger_tpu_torch.models import legacy_convert as tlc
from jaeger_tpu_torch.models import tf_checkpoint as tck
from jaeger_tpu_torch.train import tfrecord as ttf

ROOT = Path(__file__).resolve().parents[1]
FASTA = ROOT / "jaeger_tpu" / "data" / "test" / "test_contigs.fasta"
WRES_H5 = ROOT / "jaeger_tpu" / "data" / "models" / "default" / "WRes_1024.h5"

#: writes a SavedModel of the WRes weights: one ``tf.Module`` a Keras
#: layer, its variables named ``<layer>/<attr>`` as Keras names them
SAVED_MODEL_WRITER = textwrap.dedent("""
    import sys
    import h5py
    import numpy as np
    import tensorflow as tf

    tensors = {}
    with h5py.File(sys.argv[1], "r") as f:
        def walk(group, prefix=""):
            for key in group:
                item = group[key]
                if isinstance(item, h5py.Dataset):
                    name = f"{prefix}/{key}".lstrip("/").removesuffix(":0")
                    layer, attr = name.split("/")[-2:]
                    # the h5 names the first conv conv1d
                    tensors[("block1_0" if layer == "conv1d" else layer,
                             attr)] = np.asarray(item)
                else:
                    walk(item, f"{prefix}/{key}")
        walk(f)
    root = tf.Module()
    layers = {}
    for (layer, attr), value in tensors.items():
        module = layers.setdefault(layer, tf.Module())
        setattr(module, attr, tf.Variable(
            value, name=f"{layer}/{attr}",
            trainable=not attr.startswith("moving")))
    for layer, module in layers.items():
        setattr(root, layer.replace("-", "_"), module)
    tf.saved_model.save(root, sys.argv[2])
    print("written", len(tensors))
""")


@pytest.fixture(scope="module")
def saved_model(tmp_path_factory):
    """A SavedModel directory written by TensorFlow in a subprocess."""
    out = tmp_path_factory.mktemp("wres") / "saved_model"
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "TF_CPP_MIN_LOG_LEVEL": "3"}
    proc = subprocess.run(
        [sys.executable, "-c", SAVED_MODEL_WRITER, str(WRES_H5), str(out)],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "written 79" in proc.stdout
    return out


# --- TFRecord ----------------------------------------------------------------

def _examples(build):
    rng = np.random.default_rng(3)
    return [
        build({"translated": rng.integers(0, 65, 12).astype(np.int64),
               "label": np.array([2], dtype=np.int64),
               "weight": rng.random(3).astype(np.float32),
               "name": b"contig_1"}),
        build({"label": np.array([0], dtype=np.int64),
               "names": [b"a", "bc"],
               "big": np.array([2 ** 40, 7], dtype=np.int64)}),
        b"",
    ]


def test_tfrecord_bytes_equal_jax(tmp_path):
    want = _examples(jtf.build_example)
    got = _examples(ttf.build_example)
    assert got == want
    jtf.write_tfrecord(tmp_path / "j.tfrecord", want)
    ttf.write_tfrecord(tmp_path / "t.tfrecord", got)
    assert (tmp_path / "t.tfrecord").read_bytes() == (
        tmp_path / "j.tfrecord").read_bytes()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_tfrecord_each_reads_the_other(tmp_path, writer):
    path = tmp_path / "x.tfrecord"
    (jtf if writer == "jax" else ttf).write_tfrecord(
        path, _examples(jtf.build_example))
    got = [ttf.parse_example(p) for p in ttf.iter_tfrecords(path)]
    want = [jtf.parse_example(p) for p in jtf.iter_tfrecords(path)]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    np.testing.assert_array_equal(got[0]["label"], [2])
    np.testing.assert_array_equal(got[1]["big"], [2 ** 40, 7])
    assert list(got[1]["names"]) == [b"a", b"bc"]


@pytest.mark.parametrize("n", [0, 1, 9, 100, 4096])
def test_crc32c_equals_jax(n):
    data = np.random.default_rng(n).integers(0, 256, n).astype(
        np.uint8).tobytes()
    assert ttf._crc32c(data) == jtf._crc32c(data)
    assert ttf._masked_crc(data) == jtf._masked_crc(data)
    # the CRC32C check value of "123456789"
    assert ttf._crc32c(b"123456789") == 0xE3069283


@pytest.mark.parametrize("at", ["payload", "length"])
def test_tfrecord_corruption_detected(tmp_path, at):
    path = tmp_path / "c.tfrecord"
    ttf.write_tfrecord(path, [b"hello world payload"])
    data = bytearray(path.read_bytes())
    data[15 if at == "payload" else 2] ^= 0xFF
    path.write_bytes(bytes(data))
    for reader in (ttf.iter_tfrecords, jtf.iter_tfrecords):
        with pytest.raises(ValueError, match="corrupt TFRecord"):
            list(reader(path))
    # unvalidated reads go through the length check's absence alike
    if at == "payload":
        assert list(ttf.iter_tfrecords(path, validate=False)) == list(
            jtf.iter_tfrecords(path, validate=False))


def test_varint_and_fields_equal_jax():
    buf = b"".join(
        bytes([f << 3 | 0]) + bytes([0x96, 0x01]) for f in (1, 2)) + \
        bytes([3 << 3 | 2, 3]) + b"abc" + bytes([4 << 3 | 5]) + b"\x00" * 4 + \
        bytes([5 << 3 | 1]) + b"\x01" * 8
    assert list(ttf._parse_fields(buf)) == list(jtf._parse_fields(buf))
    assert ttf._read_varint(bytes([0xAC, 0x02]), 0) == (300, 2)
    with pytest.raises(ValueError, match="wire type"):
        list(ttf._parse_fields(bytes([1 << 3 | 3])))


# --- the SavedModel reader ---------------------------------------------------

def test_read_index_equals_jax(saved_model):
    index = saved_model / "variables" / "variables.index"
    got, want = tck.read_index(index), jck.read_index(index)
    assert got == want
    assert "_CHECKPOINTABLE_OBJECT_GRAPH" in got
    # 79 weights, the object graph
    assert len(got) == 80


def test_read_index_refuses_other_files(tmp_path):
    path = tmp_path / "not_an_index"
    path.write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="TensorBundle"):
        tck.read_index(path)


def test_load_checkpoint_equals_jax(saved_model):
    got, want = tck.load_checkpoint(saved_model), jck.load_checkpoint(
        saved_model)
    assert list(got) == list(want)
    assert len(got) == 79
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # object paths resolved through the object graph
    assert any(k.endswith("augdense-1/kernel") for k in got)


def test_object_graph_paths_equal_jax(saved_model):
    var_dir = saved_model / "variables"
    og = tck.read_index(var_dir / "variables.index")[
        "_CHECKPOINTABLE_OBJECT_GRAPH"]
    blob = (var_dir / "variables.data-00000-of-00001").read_bytes()[
        og["offset"]: og["offset"] + og["size"]]
    length, pos = ttf._read_varint(blob, 0)
    payload = blob[pos + 4: pos + 4 + length]
    nodes = tck.decode_object_graph(payload)
    assert nodes == jck.decode_object_graph(payload)
    assert tck.checkpoint_key_paths(nodes) == jck.checkpoint_key_paths(nodes)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _assert_trees_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert list(g) == list(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=str(k))


def test_convert_wres_checkpoint_equals_jax_and_h5(saved_model):
    got = tlc.convert_wres_checkpoint(saved_model)
    _assert_trees_equal(got, jlc.convert_wres_checkpoint(saved_model))
    _assert_trees_equal(got, tlc.convert_wres_h5(WRES_H5))


def test_convert_wres_checkpoint_names_a_missing_tensor(tmp_path,
                                                       saved_model):
    with pytest.raises(KeyError, match="block2_51/kernel"):
        tlc.convert_wres_checkpoint(saved_model, num_res_blocks=6)


def test_convert_weights_saved_model_bytes_equal_jax(tmp_path, saved_model):
    from click.testing import CliRunner

    from jaeger_tpu import cli as jcli

    cli.main(["utils", "convert-weights", "-i", str(saved_model), "-o",
              str(tmp_path / "torch")])
    r = CliRunner().invoke(jcli.main, ["utils", "convert-weights", "-i",
                                       str(saved_model), "-o",
                                       str(tmp_path / "jax")],
                           catch_exceptions=False)
    assert r.exit_code == 0, r.output
    for name in ("params.msgpack", "legacy.yaml"):
        assert (tmp_path / "torch" / name).read_bytes() == (
            tmp_path / "jax" / name).read_bytes(), name


def test_predict_legacy_on_a_saved_model_equals_jax(tmp_path, saved_model):
    out = tmp_path / "torch"
    cli.main(["predict-legacy", "-i", str(FASTA), "-o", str(out),
              "--model-dir", str(saved_model), "--device", "cpu",
              "--workers", "1"])
    want = jpl.run_core(str(FASTA), str(tmp_path / "jax"),
                        model_dir=saved_model, workers=1)
    assert want.name == "test_contigs_default_jaeger.tsv"
    assert (out / want.name).read_bytes() == want.read_bytes()
    phages = "test_contigs_default_phages_jaeger.tsv"
    assert (out / phages).read_bytes() == (
        tmp_path / "jax" / phages).read_bytes()
    assert want.read_bytes().count(b"\n") == 10


# --- snappy blocks -----------------------------------------------------------

def _varint(v: int) -> bytes:
    out = b""
    while True:
        b, v = v & 0x7F, v >> 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _literal(data: bytes) -> bytes:
    n = len(data) - 1
    if n < 60:
        return bytes([n << 2]) + data
    extra = (n.bit_length() + 7) // 8
    return bytes([(59 + extra) << 2]) + n.to_bytes(extra, "little") + data


def _snappy_stream():
    """(compressed, plain): every element kind snappy has."""
    rng = np.random.default_rng(7)
    head = rng.integers(0, 256, 300).astype(np.uint8).tobytes()
    parts = [_literal(head[:5]), _literal(head[5:80]), _literal(head[80:300])]
    plain = bytearray(head)

    def copy(length, offset, kind):
        nonlocal parts
        if kind == 1:
            tag = ((offset >> 8) << 5) | ((length - 4) << 2) | 1
            parts.append(bytes([tag, offset & 0xFF]))
        elif kind == 2:
            parts.append(bytes([((length - 1) << 2) | 2])
                         + offset.to_bytes(2, "little"))
        else:
            parts.append(bytes([((length - 1) << 2) | 3])
                         + offset.to_bytes(4, "little"))
        for _ in range(length):
            plain.append(plain[-offset])

    copy(11, 7, 1)      # 1-byte offset
    copy(8, 2, 1)       # overlapping: a run
    copy(40, 250, 2)    # 2-byte offset
    copy(64, 290, 3)    # 4-byte offset
    parts.append(_literal(b"tail"))
    plain += b"tail"
    return _varint(len(plain)) + b"".join(parts), bytes(plain)


def test_snappy_decompress_equals_jax():
    compressed, plain = _snappy_stream()
    assert tck._snappy_decompress(compressed) == plain
    assert jck._snappy_decompress(compressed) == plain


@pytest.mark.parametrize("ctype", [0, 1, 2])
def test_read_block_by_trailer(ctype):
    compressed, plain = _snappy_stream()
    body = plain if ctype == 0 else compressed
    data = b"xx" + body + bytes([ctype]) + struct.pack("<I", 0)
    if ctype == 2:
        for mod in (tck, jck):
            with pytest.raises(ValueError, match="compression"):
                mod._read_block(data, 2, len(body))
        return
    assert tck._read_block(data, 2, len(body)) == plain
    assert jck._read_block(data, 2, len(body)) == plain
