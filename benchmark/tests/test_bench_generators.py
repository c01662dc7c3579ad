"""Traffic from the seed: the same seed writes the same bytes; another
seed the same work in another order."""

import numpy as np
import pytest

from benchmark.harness.cell import load_cell

SEEDS = (7, 2**31 + 11, 3 * 2**31 + 5)


def _assembly(tmp_path, seed, sub):
    cell = load_cell("flagship.predict")
    params = dict(cell.traffic["params"], contigs=60)
    d = tmp_path / sub
    d.mkdir()
    out = cell.generator().make(params, seed, d)
    return (d / "assembly.fasta").read_bytes(), out["seqs"]


def _fragments(tmp_path, seed, sub):
    cell = load_cell("flagship.train")
    params = dict(cell.traffic["params"], rows=300)
    d = tmp_path / sub
    d.mkdir()
    cell.generator().make(params, seed, d, 1505, 6)
    return (d / "train.csv").read_bytes()


@pytest.mark.parametrize("seed", SEEDS)
def test_assembly_same_seed_same_bytes(tmp_path, seed):
    a, seqs = _assembly(tmp_path, seed, "a")
    b, _ = _assembly(tmp_path, seed, "b")
    assert a == b
    assert a.count(b">") == len(seqs) == 60
    lengths = sorted(len(s) for s in seqs)
    assert lengths[0] == 5000 and lengths[-1] == 75000
    assert sum(bytes(s).count(b"N") > 0 for s in seqs) == 60 // 7


def test_assembly_other_seed_same_work(tmp_path):
    a, sa = _assembly(tmp_path, SEEDS[0], "a")
    b, sb = _assembly(tmp_path, SEEDS[1], "b")
    assert a != b
    assert sorted(map(len, sa)) == sorted(map(len, sb))
    assert (sum(bytes(s).count(b"N") for s in sa) == sum(bytes(s).count(b"N") for s in sb))


@pytest.mark.parametrize("seed", SEEDS)
def test_fragments_same_seed_same_bytes(tmp_path, seed):
    a = _fragments(tmp_path, seed, "a")
    assert a == _fragments(tmp_path, seed, "b")
    rows = a.decode().splitlines()
    assert len(rows) == 300 and all(len(r) == 2 + 1505 + 95 for r in rows)
    assert "N" not in a.decode()
    labels = np.array([int(r[0]) for r in rows])
    assert np.bincount(labels).tolist() == [50] * 6


def test_fragments_other_seed_same_labels(tmp_path):
    a = _fragments(tmp_path, SEEDS[0], "a").decode().splitlines()
    b = _fragments(tmp_path, SEEDS[1], "b").decode().splitlines()
    assert a != b
    assert sorted(r[0] for r in a) == sorted(r[0] for r in b)
