"""A whole run on the CPU (the tiny cell, the port's plain versions), its
result line, its check, and the guards of a run."""
import json
import os
import subprocess
import sys
import time
import types

import pytest

from portbench import harness
from portbench.tests.conftest import PORTBENCH, ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(tiny, capsys, trace=0, seed=5):
    rc = harness.main(["--workload", tiny["workload"], "--seed", str(seed),
                       "--seconds", "1", "--trace", str(trace)],
                      time.perf_counter(), device="cpu", root=tiny["root"],
                      here=tiny["here"], cache=tiny["cache"])
    out, err = capsys.readouterr()
    return rc, out, err


def test_last_line_has_the_contract_keys(tiny, capsys):
    rc, out, err = _run(tiny, capsys)
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == KEYS and list(line)[-1] == "compared"
    assert line["correct"] is True
    assert line["attempted"] >= 1 and line["failed"] == 0
    # card_ms_per_set needs the device trace, which a CPU run has not
    assert set(line["metrics"]) == {"setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    tail = err.strip().splitlines()[-10:]
    assert all(t.startswith("compared ") for t in tail)


def test_traced_run_reports_the_layers(tiny, capsys):
    rc, out, _ = _run(tiny, capsys, trace=1, seed=6)
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert {"sets_per_s.host_paced", "search_s.host_paced",
            "control_s.host_paced", "post_search_s.host_paced",
            "gc_s.host_paced"} <= set(line["metrics"])


def test_forbidden_modules_compare_whole_names():
    assert harness.forbidden_modules({"spacepharer_tpu_torch.ops": 1,
                                      "jaxtyping": 1, "numpy": 1}) == []
    assert harness.forbidden_modules({"jax.numpy": 1,
                                      "spacepharer_tpu.ops.sw": 1}) == [
        "jax", "spacepharer_tpu"]


def test_a_run_that_loaded_jax_prints_no_result(tiny, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, out, err = _run(tiny, capsys, seed=7)
    assert rc != 0 and out.strip() == ""
    assert "jax" in err


def test_a_run_without_a_card_prints_no_result(tiny, capsys):
    rc = harness.main(["--workload", tiny["workload"], "--seed", "1",
                       "--seconds", "1", "--trace", "0"], time.perf_counter(),
                      root=tiny["root"], here=tiny["here"],
                      cache=tiny["cache"])
    out, _ = capsys.readouterr()
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is attached")
    assert rc != 0 and out.strip() == ""


def test_the_benchmark_alone_prints_no_result(tmp_path):
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "dense.genome_sets", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
def test_cell_runs_on_the_card(tmp_path):
    """One short run of each cell on the card, correct."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import cells
    for w in cells.benchmark()["workloads"]:
        proc = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", w["name"],
             "--seed", "3", "--seconds", "5", "--trace", "0"], cwd=ROOT,
            capture_output=True, text=True, timeout=1200)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]
