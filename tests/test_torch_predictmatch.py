"""The port's predictmatch end to end on the golden bundle.

tests/golden_run.tar.gz holds the reference's own DBs (the query setDB
under run/tmp/*/qsetdb, run/targets and run/targets_rev) and its
result.tsv. Both packages must reproduce that text byte for byte from
those DBs, with every scoring engine the port has on the CPU.
"""
import glob
import os

import pytest

from spacepharer_tpu.io.setdb import SetDB as JaxSetDB
from spacepharer_tpu.pipeline import predictmatch as jax_pm
from spacepharer_tpu_torch.io.setdb import SetDB
from spacepharer_tpu_torch.pipeline import predictmatch as pm


def _golden_paths(golden):
    # tmp/latest links to the run's own tmp/<hash> directory
    (qpath,) = {os.path.realpath(p) for p in
                glob.glob(os.path.join(golden, "tmp", "*", "qsetdb"))}
    return qpath, os.path.join(golden, "targets"), \
        os.path.join(golden, "targets_rev")


@pytest.fixture(scope="module")
def golden_dbs(golden):
    """(query, target, control) SetDBs of the golden bundle, loaded by
    the port, and the golden result.tsv text."""
    dbs = tuple(SetDB.load(p) for p in _golden_paths(golden))
    with open(os.path.join(golden, "result.tsv")) as fh:
        return dbs, fh.read()


@pytest.mark.parametrize("engine", ["host", "use_tpu", "key_blocked"])
def test_golden_result_byte_identical(golden_dbs, engine, monkeypatch):
    """Host engine; the device engine forced on (asked for on the CPU:
    the torch scan); and forced on with a 500-cell score-matrix budget,
    which splits the queries into many key blocks."""
    (qdb, tdb, cdb), text = golden_dbs
    if engine == "key_blocked":
        monkeypatch.setattr(pm, "_MAX_MATRIX_CELLS", 500)
    params = pm.PredictParams(use_tpu=None if engine == "host" else True,
                              device="cpu")
    res = pm.predict_match(qdb, tdb, cdb, params)
    assert res.text == text


def test_golden_matches_jax_package(golden_dbs, golden):
    (qdb, tdb, cdb), text = golden_dbs
    jax_dbs = [JaxSetDB.load(p) for p in _golden_paths(golden)]
    ref = jax_pm.predict_match(*jax_dbs)
    got = pm.predict_match(qdb, tdb, cdb)
    assert got.text == ref.text == text
    assert got.match == ref.match
    assert got.cscore == ref.cscore and got.cscore_rev == ref.cscore_rev


def test_golden_regression_invariant_six_hits(golden_dbs):
    """util/run_regression.sh check 1: exactly 6 hits with p_bh < 1e-3."""
    (qdb, tdb, cdb), _ = golden_dbs
    res = pm.predict_match(qdb, tdb, cdb, pm.PredictParams(use_tpu=True,
                                                           device="cpu"))
    hits = [line for line in res.text.split("\n")
            if line.startswith(">") and float(line.split("\t")[2]) < 1e-3]
    assert len(hits) == 6


def test_golden_cli_predictmatch_use_tpu_traced(golden_dbs, golden,
                                                 tmp_path, monkeypatch):
    """The CLI entry with --use-tpu 1 (asked for on the CPU) and
    --trace-dir: golden bytes, a torch.profiler trace of the whole call,
    and spans.json with both searches' spans and the counters."""
    import json
    from spacepharer_tpu_torch import cli
    monkeypatch.setenv(pm.DEVICE_ENV, "cpu")
    _, text = golden_dbs
    out = tmp_path / "result.tsv"
    trace_dir = tmp_path / "trace"
    rc = cli.main(["predictmatch", *_golden_paths(golden), str(out),
                   str(tmp_path / "tmp"), "--use-tpu", "1", "-v", "1",
                   "--trace-dir", str(trace_dir)])
    assert rc == 0
    assert out.read_text() == text
    assert (trace_dir / "predictmatch.trace.json").stat().st_size > 0
    spans = json.loads((trace_dir / "spans.json").read_text())
    by_id = {r["id"]: r for r in spans["spans"]}
    for stage in ("search", "search_rev"):
        (top,) = [r for r in by_id.values() if r["name"] == stage]
        children = [r for r in by_id.values()
                    if r["name"] == "search_setdbs"
                    and r["parent"] == top["id"]]
        assert len(children) == 1
    assert spans["counters"]["candidate_pairs"] > 0


@pytest.mark.parametrize("mesh", [(1, 8), (2, 4), (4, 2)])
def test_golden_mesh_byte_identical(golden_dbs, mesh, monkeypatch):
    """The device mesh (--shards) asked for on the CPU: every shard on
    the CPU, scored by the dense kernels' plain versions."""
    from spacepharer_tpu_torch.parallel import sharding
    (qdb, tdb, cdb), text = golden_dbs
    shapes = []
    orig = sharding.sharded_allpairs_scores
    monkeypatch.setattr(sharding, "sharded_allpairs_scores",
                        lambda m, *a, **kw: shapes.append(m.shape)
                        or orig(m, *a, **kw))
    res = pm.predict_match(qdb, tdb, cdb, pm.PredictParams(mesh=mesh,
                                                           device="cpu"))
    assert res.text == text
    assert shapes == [mesh, mesh]          # forward and control searches


def test_golden_mesh_matches_jax_package(golden_dbs, golden):
    (qdb, tdb, cdb), text = golden_dbs
    jax_dbs = [JaxSetDB.load(p) for p in _golden_paths(golden)]
    ref = jax_pm.predict_match(*jax_dbs, jax_pm.PredictParams(mesh=(2, 4)))
    got = pm.predict_match(qdb, tdb, cdb, pm.PredictParams(mesh=(2, 4),
                                                           device="cpu"))
    assert got.text == ref.text == text
    assert got.match == ref.match
    assert got.cscore == ref.cscore and got.cscore_rev == ref.cscore_rev


def test_golden_cli_shards(golden, tmp_path, monkeypatch):
    """The CLI's --shards 2,4 with --use-tpu 1 (asked for on the CPU):
    golden bytes."""
    from spacepharer_tpu_torch import cli
    monkeypatch.setenv(pm.DEVICE_ENV, "cpu")
    with open(os.path.join(golden, "result.tsv")) as fh:
        text = fh.read()
    out = tmp_path / "result.tsv"
    rc = cli.main(["predictmatch", *_golden_paths(golden), str(out),
                   str(tmp_path / "tmp"), "--shards", "2,4", "--use-tpu",
                   "1", "-v", "1"])
    assert rc == 0
    assert out.read_text() == text


def test_golden_dense_prefilter_byte_identical(golden_dbs, monkeypatch):
    """engine="device": the dense prefilter (asked for on the CPU: the
    kernels' plain versions) feeds the host scoring engine."""
    from spacepharer_tpu_torch.ops import prefilter_dense
    (qdb, tdb, cdb), text = golden_dbs
    calls = []
    orig = prefilter_dense.match_pairs
    monkeypatch.setattr(prefilter_dense, "match_pairs",
                        lambda *a, **kw: calls.append(kw["device"])
                        or orig(*a, **kw))
    params = pm.PredictParams(
        prefilter=pm.PrefilterParams(engine="device"), device="cpu")
    assert pm.predict_match(qdb, tdb, cdb, params).text == text
    assert calls == ["cpu", "cpu"]        # forward and control searches


def test_golden_cli_dense_prefilter(golden, tmp_path, monkeypatch):
    """The CLI's --prefilter-engine device with --use-tpu 0 (only the
    prefilter on the device, asked for on the CPU): golden bytes."""
    from spacepharer_tpu_torch import cli
    monkeypatch.setenv(pm.DEVICE_ENV, "cpu")
    with open(os.path.join(golden, "result.tsv")) as fh:
        text = fh.read()
    out = tmp_path / "result.tsv"
    rc = cli.main(["predictmatch", *_golden_paths(golden), str(out),
                   str(tmp_path / "tmp"), "--prefilter-engine", "device",
                   "--use-tpu", "0", "-v", "1"])
    assert rc == 0
    assert out.read_text() == text


# route -> (its PredictParams fields, the words its error names)
DEVICE_ROUTES = {
    "use_tpu": ({"use_tpu": True}, "GPU scoring engine"),
    "mesh": ({"mesh": (2, 4)}, "device mesh"),
    "dense": ({"prefilter": pm.PrefilterParams(engine="device")},
              "dense prefilter"),
}


@pytest.mark.parametrize("route", list(DEVICE_ROUTES))
def test_device_route_without_a_card_raises(golden_dbs, route, monkeypatch):
    """A device route asked for on a machine without a card, and not
    asked for on the CPU, raises a RuntimeError naming the route instead
    of running on the CPU."""
    import torch
    (qdb, tdb, _), _ = golden_dbs
    monkeypatch.setattr(pm, "_start_torch_probe", lambda: None)
    monkeypatch.setattr(pm, "_accelerator_present", lambda: False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fields, words = DEVICE_ROUTES[route]
    with pytest.raises(RuntimeError, match=words):
        pm.search_setdbs(qdb, tdb, pm.PredictParams(perform_nucl_aln=False,
                                                    **fields))


@pytest.mark.parametrize("ask,raises", [
    pytest.param(None, RuntimeError, id="unset"),
    pytest.param("cpu", None, id="cpu"),
    pytest.param("gpu", ValueError, id="unknown"),
])
def test_cli_reads_the_device_ask(golden, tmp_path, monkeypatch, ask,
                                  raises):
    """The CLI takes PredictParams.device from DEVICE_ENV: --use-tpu 1
    without a card raises unless it asks for the CPU, which gives the
    golden bytes; any other value raises."""
    from spacepharer_tpu_torch import cli
    monkeypatch.setattr(pm, "_start_torch_probe", lambda: None)
    monkeypatch.setattr(pm, "_accelerator_present", lambda: False)
    if ask is None:
        monkeypatch.delenv(pm.DEVICE_ENV, raising=False)
    else:
        monkeypatch.setenv(pm.DEVICE_ENV, ask)
    out = tmp_path / "result.tsv"
    argv = ["predictmatch", *_golden_paths(golden), str(out),
            str(tmp_path / "tmp"), "--use-tpu", "1", "-v", "1"]
    if raises is not None:
        with pytest.raises(raises, match=pm.DEVICE_ENV):
            cli.main(argv)
        return
    assert cli.main(argv) == 0
    with open(os.path.join(golden, "result.tsv")) as fh:
        assert out.read_text() == fh.read()
