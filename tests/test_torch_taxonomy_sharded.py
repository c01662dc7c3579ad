"""The port's row-sharded taxonomy search against `jaeger_tpu`'s.

``CosineIndex._search_sharded`` at mesh widths 1 to 8 (the port's
``DeviceMesh(("cpu",) * width)``, JAX's mesh of that many virtual CPU
devices) on an index with duplicated rows (ties at and across shard
boundaries) whose row count is not a multiple of the width: the indices
exactly equal to JAX's and to the port's one-device search, the scores
within 1e-6 (the same tolerance as ``tests/test_torch_commands.py``'s
search; both packages multiply in f32 in their own order). Then
``predict_taxonomy`` with a mesh writes the one-device TSV.
"""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from jaeger_tpu.commands import taxonomy as jtax
from jaeger_tpu_torch.commands import taxonomy as ttax
from jaeger_tpu_torch.parallel.mesh import DeviceMesh


def _index(seed=7, n=43, d=8):
    rng = np.random.default_rng(seed)
    index = rng.normal(size=(n, d)).astype(np.float32)
    for dup in (9, 17, 33, 38, 42):              # five copies of row 2
        index[dup] = index[2]
    index[25] = index[11]
    index[6] = index[5]                          # a tie across shards
    queries = np.concatenate([index[[2, 11, 5, 38]],
                              rng.normal(size=(11, d)).astype(np.float32)])
    return index, queries


@pytest.mark.parametrize("width", list(range(1, 9)))
@pytest.mark.parametrize("k", [3, 5])
def test_sharded_search_equals_jax_and_one_device(width, k):
    index, queries = _index()
    taxids = np.arange(1, len(index) + 1)
    q = ttax._l2_normalize(queries)
    s_t, i_t = ttax.CosineIndex(index, taxids)._search_sharded(
        q, k, DeviceMesh(("cpu",) * width))
    s_j, i_j = jtax.CosineIndex(index, taxids)._search_sharded(
        q, k, Mesh(np.array(jax.devices()[:width]), ("data",)))
    s_1, i_1 = ttax.CosineIndex(index, taxids).search(queries, k=k,
                                                      device="cpu")
    i_t, s_t = np.asarray(i_t), np.asarray(s_t)
    np.testing.assert_array_equal(i_t, np.asarray(i_j))
    np.testing.assert_array_equal(i_t, i_1)
    np.testing.assert_allclose(s_t, np.asarray(s_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(s_t, s_1, rtol=0, atol=1e-6)
    assert list(i_t[0]) == [2, 9, 17, 33, 38, 42][:k]
    assert list(i_t[2][:2]) == [5, 6]


def test_chunked_sharded_search(monkeypatch):
    """Query chunks (a small ``SEARCH_CHUNK_ELEMENTS``) change nothing."""
    index, queries = _index(seed=3)
    taxids = np.arange(1, len(index) + 1)
    want = ttax.CosineIndex(index, taxids).search(
        queries, k=4, mesh=DeviceMesh(("cpu",) * 3))
    monkeypatch.setattr(ttax, "SEARCH_CHUNK_ELEMENTS", 15 * 4)
    got = ttax.CosineIndex(index, taxids).search(
        queries, k=4, mesh=DeviceMesh(("cpu",) * 3))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def test_predict_taxonomy_on_a_mesh(tmp_path):
    """``predict_taxonomy`` with the index sharded over three CPU devices
    writes the one-device TSV byte for byte."""
    from tests.test_torch_commands import E2E_CONFIG, _taxonomy_fixture

    from jaeger_tpu.models.artifacts import save_model
    from jaeger_tpu.models.builder import ModelBuilder

    _, variables = ModelBuilder(E2E_CONFIG).init()
    bundle = tmp_path / "model"
    save_model(variables, E2E_CONFIG, bundle)
    fasta, dump, acc = _taxonomy_fixture(tmp_path)
    kw = dict(fsize=400, batch=8, precision="float32", device="cpu")
    db = ttax.build_taxdb(str(bundle), str(fasta), str(acc), str(dump),
                          str(tmp_path / "db"), **kw)
    one = ttax.predict_taxonomy(str(bundle), str(db), str(fasta),
                                str(tmp_path / "one.tsv"), **kw)
    three = ttax.predict_taxonomy(str(bundle), str(db), str(fasta),
                                  str(tmp_path / "three.tsv"),
                                  mesh=DeviceMesh(("cpu",) * 3), **kw)
    assert three.read_bytes() == one.read_bytes()
    assert one.read_bytes().count(b"\n") == 3
