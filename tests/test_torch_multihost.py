"""The port's multi-host ``predict`` against `jaeger_tpu` on the CPU.

Covered: the pure helpers of ``parallel/multihost.py`` (``contig_owner``
on 1,000 headers, ``filter_contigs_for_host``, ``shard_path``,
``merge_output_shards`` byte for byte on the same shards, an empty and a
missing one included); two hosts that finish together merge once
(``merge_when_complete`` under ``merge_lock``), where JAX's second merge
overwrites the table with what is left; ``run_core`` with
``num_hosts=2`` and host ids 0 and 1 on the demo bundle and
``test_contigs.fasta``: each shard and the merged TSV byte-identical
to JAX's ``run_core`` with the same arguments, and the merged TSV's rows
to the port's one-host TSV's (the merge lists host 0's contigs first,
as JAX's does); a host that owns no contig writes an empty shard; the
CLI's ``--num-hosts`` / ``--host-id`` and ``--devices``; the
process-group helpers outside a group.

JAX runs its ``run_core`` with ``devices=1``: its f32 output moves with
its device count (ROADMAP.md queue 3), and the port's one-device run is
the one to equal.
"""

from pathlib import Path

import numpy as np
import pytest

from jaeger_tpu.parallel import multihost as jmh
from jaeger_tpu_torch import cli
from jaeger_tpu_torch.parallel import multihost as tmh

ROOT = Path(__file__).resolve().parent.parent
FASTA = ROOT / "jaeger_tpu" / "data" / "test" / "test_contigs.fasta"
DEMO = ROOT / "jaeger_tpu" / "data" / "models" / "demo"
TSV = "test_contigs_default_jaeger.tsv"
COMMON = dict(fsize=2000, stride=1500, precision="float32", workers=1)


def test_contig_owner_matches_jax():
    rng = np.random.default_rng(3)
    headers = [f"contig_{i}_" + "".join(rng.choice(list("ACGTN_x|"), 12))
               for i in range(1000)]
    for hosts in (1, 2, 3, 8):
        got = [tmh.contig_owner(h, hosts) for h in headers]
        assert got == [jmh.contig_owner(h, hosts) for h in headers]
        assert set(got) == set(range(hosts))
    records = [(h, "ACGT") for h in headers[:50]]
    for host in range(3):
        assert (list(tmh.filter_contigs_for_host(records, host, 3))
                == list(jmh.filter_contigs_for_host(records, host, 3)))
    assert tmh.shard_path("a/b.tsv", 7) == jmh.shard_path("a/b.tsv", 7)


@pytest.mark.parametrize("layout", ["full", "empty_shard", "missing_shard"])
def test_merge_output_shards_byte_equal_to_jax(tmp_path, layout):
    shards = {0: "contig\tscore\na\t1\n", 1: "contig\tscore\nb\t2\nc\t3\n",
              2: "contig\tscore\nd\t4\n"}
    if layout == "empty_shard":
        shards[0] = ""
    elif layout == "missing_shard":
        del shards[1]
    outs = {}
    for name, mod in (("jax", jmh), ("torch", tmh)):
        base = tmp_path / name / "out.tsv"
        base.parent.mkdir()
        for host, text in shards.items():
            mod.shard_path(base, host).write_text(text)
        outs[name] = mod.merge_output_shards(base, 3).read_bytes()
        assert not any(mod.shard_path(base, h).exists() for h in range(3))
        assert not (tmp_path / name / "out.tsv.merging").exists()
    assert outs["torch"] == outs["jax"]
    assert outs["torch"].startswith(b"contig\tscore\n")


def _write_shards(base):
    shards = {0: "contig\tscore\na\t1\n", 1: "contig\tscore\nb\t2\n"}
    for host, text in shards.items():
        tmh.shard_path(base, host).write_text(text)
    return "contig\tscore\na\t1\nb\t2\n"


@pytest.mark.parametrize("interleave", ["late_second_merge", "lock_held"])
def test_two_hosts_finishing_together_merge_once(tmp_path, interleave):
    """Both hosts saw every shard; one merges. ``late_second_merge``: the
    second comes after the first deleted the shards and returns None,
    leaving the table whole, where JAX's ``merge_output_shards`` run
    again (its ``_maybe_merge_shards`` checked the shards before) writes
    the empty rest over it (ROADMAP.md queue 3). ``lock_held``: while
    one host holds the lock the other does not merge, and merges once the
    lock is free."""
    base = tmp_path / "out.tsv"
    whole = _write_shards(base)
    if interleave == "late_second_merge":
        assert tmh.merge_when_complete(base, 2) == base
        assert tmh.merge_when_complete(base, 2) is None
        assert base.read_text() == whole
        jbase = tmp_path / "jax.tsv"
        _write_shards(jbase)
        jmh.merge_output_shards(jbase, 2)
        assert jbase.read_text() == whole
        jmh.merge_output_shards(jbase, 2)
        assert jbase.read_text() == ""
    else:
        with tmh.merge_lock(base) as held:
            assert held
            with tmh.merge_lock(base) as again:
                assert not again
            assert tmh.merge_when_complete(base, 2) is None
            assert tmh.shard_path(base, 1).exists() and not base.exists()
        assert tmh.merge_when_complete(base, 2) == base
        assert base.read_text() == whole
    assert not list(tmp_path.glob("out.tsv.*"))


def test_run_core_two_hosts_match_one_host_and_jax(tmp_path):
    from jaeger_tpu.commands.predict import run_core as jax_run_core
    from jaeger_tpu_torch.commands.predict import run_core

    one = run_core(str(FASTA), str(tmp_path / "one"), str(DEMO),
                   device="cpu", **COMMON).read_bytes()
    got = {}
    for name, fn, extra in (("jax", jax_run_core, {"devices": 1}),
                            ("torch", run_core, {"device": "cpu"})):
        out = tmp_path / name
        first = fn(str(FASTA), str(out), str(DEMO), num_hosts=2, host_id=0,
                   **COMMON, **extra)
        # host 0 alone: its shard, no merge yet
        assert first == tmh.shard_path(out / TSV, 0)
        got[name + "0"] = first.read_bytes()
        merged = fn(str(FASTA), str(out), str(DEMO), num_hosts=2, host_id=1,
                    **COMMON, **extra)
        assert merged == out / TSV
        got[name] = merged.read_bytes()
        assert not tmh.shard_path(out / TSV, 1).exists()
        assert not list(out.glob("*.partial"))
    assert got["torch0"] == got["jax0"]
    assert got["torch"] == got["jax"]
    assert _rows(got["torch"]) == _rows(one)
    assert one.count(b"\n") == 10
    assert 1 < got["torch0"].count(b"\n") < 10


def _rows(tsv: bytes):
    """The header and the sorted rows: the merged table lists host 0's
    rows, then host 1's (as JAX's merge does), each byte for byte a row
    of the one-host table."""
    head, *rows = tsv.split(b"\n")
    return head, sorted(rows)


def test_host_without_contigs_writes_an_empty_shard(tmp_path):
    """One contig, two hosts: the host that does not own it writes an
    empty shard, and the merge gives the one-host table, as in JAX."""
    from jaeger_tpu.commands.predict import run_core as jax_run_core
    from jaeger_tpu_torch.commands.predict import run_core

    lines = FASTA.read_text().splitlines()
    header = lines[0][1:]
    end = next(i for i in range(1, len(lines)) if lines[i].startswith(">"))
    fasta = tmp_path / "one.fasta"
    fasta.write_text("\n".join(lines[:end]) + "\n")
    owner = tmh.contig_owner(header, 2)
    got = {}
    for name, fn, extra in (("jax", jax_run_core, {"devices": 1}),
                            ("torch", run_core, {"device": "cpu"})):
        out = tmp_path / name
        empty = fn(str(fasta), str(out), str(DEMO), num_hosts=2,
                   host_id=1 - owner, **COMMON, **extra)
        assert empty == out / "one_default_jaeger.tsv"
        assert tmh.shard_path(empty, 1 - owner).read_bytes() == b""
        got[name] = fn(str(fasta), str(out), str(DEMO), num_hosts=2,
                       host_id=owner, **COMMON, **extra).read_bytes()
    alone = run_core(str(fasta), str(tmp_path / "alone"), str(DEMO),
                     device="cpu", **COMMON).read_bytes()
    assert got["torch"] == got["jax"] == alone


def test_cli_hosts_and_devices(tmp_path):
    """``predict --num-hosts 2 --host-id 0|1`` merges to the one-host TSV;
    ``--devices 2`` on the CPU runs the engine over a two-CPU data mesh
    with the same TSV; a host id out of range is refused."""
    from jaeger_tpu_torch.commands.predict import run_core

    common = ["-i", str(FASTA), "-m", str(DEMO), "--fsize", "2000",
              "--stride", "1500", "--precision", "float32", "--device",
              "cpu", "--workers", "1"]
    cli.main(["predict", "-o", str(tmp_path / "one"), *common])
    want = (tmp_path / "one" / TSV).read_bytes()
    for host in (1, 0):
        cli.main(["predict", "-o", str(tmp_path / "hosts"), *common,
                  "--num-hosts", "2", "--host-id", str(host)])
    assert _rows((tmp_path / "hosts" / TSV).read_bytes()) == _rows(want)
    cli.main(["predict", "-o", str(tmp_path / "dp"), *common, "--devices",
              "2", "--batch", "7"])
    assert (tmp_path / "dp" / TSV).read_bytes() == want
    with pytest.raises(ValueError, match="host_id 2 out of range"):
        run_core(str(FASTA), str(tmp_path / "bad"), str(DEMO), num_hosts=2,
                 host_id=2, device="cpu", **COMMON)


def test_process_helpers_outside_a_group():
    assert tmh.initialize_distributed() == (0, 1)
    assert tmh.is_primary() and not tmh.is_multiprocess()
    assert not tmh.is_distributed()
    assert tmh.default_backend("cuda:0") == "nccl"
    assert tmh.default_backend("cpu") == "gloo"
    assert str(tmh.rank_device("cpu", 3)) == "cpu"
    assert str(tmh.rank_device("cuda:0", 3)) == "cuda:0"
    batch = {"bases": np.arange(12).reshape(6, 2), "labels": np.arange(6)}
    parts = [tmh.GlobalBatcher(rank=r, world=3).shard(batch)
             for r in range(3)]
    np.testing.assert_array_equal(
        np.concatenate([p["bases"] for p in parts]), batch["bases"])
    assert parts[1]["labels"].tolist() == [2, 3]
    with pytest.raises(ValueError, match="does not split"):
        tmh.GlobalBatcher(rank=0, world=4).shard(batch)
    import torch

    t = torch.ones(3, requires_grad=True)
    assert tmh.all_reduce_sum(t) is t
    grads = {"a": torch.ones(2)}
    assert tmh.all_reduce_mean(grads) is grads
    host = tmh.tree_to_host({"a": torch.arange(3), "b": {"c": np.ones(2)}})
    assert host["a"].tolist() == [0, 1, 2]
    assert isinstance(host["b"]["c"], np.ndarray)
