"""CPU fixtures of the benchmark's tests: a tiny cell of its own (a few
catalog genomes, a few dozen sets a call) run on the port's plain
versions (PredictParams(device="cpu"))."""
import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(PORTBENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """{root, here, cache, workload}: a BENCHMARK.json whose one cell is
    the dense configuration cut to 24 genomes under a mix of 18 sets of 3
    to 5 spacers a call with six protospacers, and a catalog cache for
    the session."""
    base = tmp_path_factory.mktemp("tiny")
    here = base / "portbench"
    (here / "configs").mkdir(parents=True)
    (here / "traffic").mkdir()
    with open(os.path.join(PORTBENCH, "configs",
                           "genbank_phage.dense.json")) as fh:
        config = json.load(fh)
    config["name"] = "tiny.dense"
    config["catalog"]["genomes"] = 24
    config["threads"] = 2
    with open(here / "configs" / "tiny.dense.json", "w") as fh:
        json.dump(config, fh)
    with open(os.path.join(PORTBENCH, "traffic", "genome_sets.json")) as fh:
        mix = json.load(fh)
    mix.update(sets_per_call=18, warm_sets=3, set_sizes=[3, 4, 5],
               hit_fraction=6 / 72)
    with open(here / "traffic" / "tiny_batch.json", "w") as fh:
        json.dump(mix, fh)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["workloads"] = [{"name": "tiny.dense", "config": "tiny.dense",
                           "traffic": "tiny_batch", "chips": 1,
                           "why": "the CPU tests' cell"}]
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny.dense"]
    with open(base / "BENCHMARK.json", "w") as fh:
        json.dump(bench, fh)
    yield dict(root=str(base), here=str(here), cache=str(base / "cache"),
               workload="tiny.dense")
    shutil.rmtree(base, ignore_errors=True)


@pytest.fixture(scope="session")
def tiny_run(tiny):
    """A set-up Run of the tiny cell (catalog built, warm call made)."""
    import time
    from portbench import cells, harness
    spec = cells.resolve(tiny["workload"], cells.benchmark(tiny["root"]),
                         tiny["here"])
    harness.pin_environment(spec["config"]["threads"])
    args = harness.parse(["--workload", tiny["workload"], "--seed", "5",
                          "--seconds", "1", "--trace", "0"])
    run = harness.Run(args, spec, "cpu", time.perf_counter(), tiny["cache"])
    run.setup()
    return run
