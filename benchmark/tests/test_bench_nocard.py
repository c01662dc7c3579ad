"""A run that finds no card fails and prints no result; so does a run from
a directory that holds only ``BENCHMARK.json`` and the benchmark's
files."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.harness.cell import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def _run(cwd, workload, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload, "--seed",
         str(2**31 + 9), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=str(cwd), env=env)


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_no_card_no_result(workload):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(ROOT, workload, env)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
    assert "CUDA card" in out.stderr


def test_benchmark_files_alone_fail(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for rel in SPEC["paths"]:
        shutil.copytree(ROOT / rel, tmp_path / rel,
                        ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    out = _run(tmp_path, SPEC["workloads"][0]["name"], env)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
