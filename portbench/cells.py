"""Cells as data: BENCHMARK.json's entries and the files they name.

A cell names a configuration (portbench/configs/<config>.json) and a
traffic mix (portbench/traffic/<traffic>.json); a per-layer metric is
portbench/metrics/<name>.py and an end-to-end metric
portbench/end_to_end/<name>.py. Nothing here knows any one of them.
"""
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def benchmark(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def resolve(workload: str, bench: dict, here=HERE) -> dict:
    """{cell, config, traffic, end_to_end, per_layer} of one workload:
    the config and traffic files loaded, the metrics that the cell
    reports (a metric with `workloads` only in those cells)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = load_json(os.path.join(here, "configs", cell["config"] + ".json"))
    traffic = load_json(os.path.join(here, "traffic",
                                     cell["traffic"] + ".json"))

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]

    return dict(cell=cell, config=config, traffic=traffic,
                end_to_end=mine(bench["end_to_end"]),
                per_layer=mine(bench["per_layer"]))


def metric_reader(name: str, here=HERE, kind="metrics"):
    """The `read(record)` function of portbench/<kind>/<name>.py: kind
    "metrics" for a per-layer metric, "end_to_end" for an end-to-end
    one."""
    path = os.path.join(here, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
