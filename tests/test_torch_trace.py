"""The port's span and counter registry (spacepharer_tpu_torch/logging.py)
on the golden bundle: the spans each route runs, the counters against
counts made here from the stages' own inputs and outputs, the registry
off (no torch, no records), and the records on torch.profiler's clock.
"""
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from spacepharer_tpu_torch import logging as plog
from spacepharer_tpu_torch.io.setdb import SetDB
from spacepharer_tpu_torch.ops import prefilter_dense
from spacepharer_tpu_torch.pipeline import predictmatch as pm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the spans of every route: the call's stages and each search's
COMMON = ("predict_match", "search", "search_rev", "aggregation",
          "besthitperset", "mergeresultsbyset", "combinescore", "fdr",
          "alignments", "report", "taxonomy", "search_setdbs",
          "target_orfs", "target_encode", "target_slices", "query_prep",
          "engine_choice", "nucl_merge", "nucl_gather", "nucl_align",
          "nucl_combine")
# route -> (its PredictParams fields, the spans it must total)
ROUTES = {
    "dense_cpu": (
        dict(prefilter=pm.PrefilterParams(engine="device"), use_tpu=True,
             device="cpu"),
        COMMON + ("masked_target", "dense_pass", "dense_target_valid",
                   "dense_query_batch", "dense_match", "dense_target",
                   "dense_counts", "dense_streams",
                   "dense_finalize", "card_scoring", "pair_score",
                   "evalue_screen", "survivor_align")),
    "host": (
        dict(use_tpu=False),
        COMMON + ("target_index", "host_prefilter", "host_align")),
}


def _golden_paths(golden):
    (qpath,) = {os.path.realpath(p) for p in
                glob.glob(os.path.join(golden, "tmp", "*", "qsetdb"))}
    return qpath, os.path.join(golden, "targets"), \
        os.path.join(golden, "targets_rev")


def _delta(before):
    now = plog.timings()
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v != before.get(k, 0)}


@pytest.fixture(scope="module")
def dbs(golden):
    return tuple(SetDB.load(p) for p in _golden_paths(golden))


@pytest.fixture(scope="module", params=sorted(ROUTES))
def route_call(request, dbs):
    """(route, the registry's increase over one golden predict_match on
    it)."""
    fields, _ = ROUTES[request.param]
    before = plog.timings()
    pm.predict_match(*dbs, pm.PredictParams(**fields))
    return request.param, _delta(before)


def test_route_spans_total(route_call):
    route, got = route_call
    missing = [s for s in ROUTES[route][1] if got.get(s, 0) <= 0]
    assert not missing
    for s in ROUTES[route][1]:
        assert 0 <= got.get(s + ".self", 0) <= got[s] + 1e-9, s
    assert got["search_setdbs.self"] < got["search_setdbs"]
    # the stage timers' scope: the forward search alone, then the
    # control search with its aggregation
    assert got["search"] < got["predict_match"]
    assert got["search_setdbs"] < got["search"] + got["search_rev"]


@pytest.fixture(scope="module")
def dense_call(dbs, golden):
    """(the registry's increase, the same counts made from what the
    stages took and gave) over one golden predict_match on the dense CPU
    route with the GPU scoring engine asked for on the CPU."""
    qdb = dbs[0]
    q_flat, q_off = qdb.orf_aa_encoded()
    q_lens = np.diff(q_off)
    span = pm.PrefilterParams().pattern_span
    want = dict(candidate_pairs=0, pair_cells=0, result_rows=0,
                protein_rows=0, query_kmers=0)
    dense, search, merge = (prefilter_dense.device_prefilter_arrays,
                            pm.search_setdbs, pm._nucl_merge)

    def _dense(q_all, keys, bias, t_flat, t_starts, *a, **kw):
        out = dense(q_all, keys, bias, t_flat, t_starts, *a, **kw)
        t, off = out[0], out[3]
        want["candidate_pairs"] += len(t)
        pair_q = np.repeat(np.asarray(keys), np.diff(off))
        want["pair_cells"] += int(np.dot(q_lens[pair_q],
                                         np.diff(t_starts)[t]))
        return out

    def _search(query_db, target_db, params, keys=None):
        out = search(query_db, target_db, params, keys=keys)
        want["result_rows"] += sum(len(r) for r in out.values())
        want["query_kmers"] += int(np.maximum(q_lens - span + 1, 0).sum())
        return out

    def _merge(prot, *a):
        want["protein_rows"] += sum(len(r) for r in prot.values())
        return merge(prot, *a)

    mp = pytest.MonkeyPatch()
    mp.setattr(prefilter_dense, "device_prefilter_arrays", _dense)
    mp.setattr(pm, "search_setdbs", _search)
    mp.setattr(pm, "_nucl_merge", _merge)
    try:
        before = plog.timings()
        res = pm.predict_match(*dbs,
                               pm.PredictParams(**ROUTES["dense_cpu"][0]))
        got = _delta(before)
    finally:
        mp.undo()
    with open(os.path.join(golden, "result.tsv")) as fh:
        assert res.text == fh.read()
    assert want["candidate_pairs"] > 0 and want["result_rows"] > 0
    return got, want


@pytest.mark.parametrize("counter", ["candidate_pairs", "pair_cells",
                                     "result_rows", "protein_rows",
                                     "query_kmers"])
def test_counter_matches_independent_count(dense_call, counter):
    got, want = dense_call
    assert got.get(counter, 0) == want[counter]


def test_dense_counters_agree(dense_call):
    """Every candidate pair is scored on this route, so the engine's
    choice counted the cells the scan scored; the rows that can match are
    some of the k-mers searched; the finalize keeps at most what the
    streams held."""
    got, _ = dense_call
    assert got["candidate_cells"] == got["pair_cells"]
    assert 0 < got["dense_rows"] <= got["query_kmers"]
    assert got["dense_cells"] >= got["dense_rows"]
    assert (got["candidate_pairs"] <= got["stream_matches"]
            <= got["dense_hits"])
    assert 0 < got["survivors"] <= got["candidate_pairs"]
    assert "h2d_bytes" not in got       # nothing went to a card


def test_recording_off_imports_no_torch(golden):
    """A host-route call in a fresh process, the registry off: its spans
    total, torch is never imported and no record is kept."""
    code = (
        "import sys\n"
        "from spacepharer_tpu_torch import logging as plog\n"
        "from spacepharer_tpu_torch.io.setdb import SetDB\n"
        "from spacepharer_tpu_torch.pipeline import predictmatch as pm\n"
        "plog.set_verbosity(plog.ERROR)\n"
        f"dbs = [SetDB.load(p) for p in {list(_golden_paths(golden))!r}]\n"
        "pm.predict_match(*dbs, pm.PredictParams(use_tpu=False))\n"
        "t = plog.timings()\n"
        "assert t['search_setdbs'] > 0 and t['candidate_pairs'] > 0, t\n"
        "assert plog._records is None\n"
        "print('torch' in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"


@pytest.mark.parametrize("clash", ["counter_then_span", "span_then_counter"])
def test_span_and_counter_names_never_clash(clash):
    name = f"probe_{clash}"
    with pytest.raises(ValueError):
        if clash == "counter_then_span":
            plog.count(name)
            with plog.span(name):
                pass
        else:
            with plog.span(name):
                pass
            plog.count(name)


def test_self_time_leaves_out_children():
    before = plog.timings()
    with plog.span("probe_outer"):
        with plog.span("probe_inner"):
            time.sleep(0.02)
        time.sleep(0.01)
    got = _delta(before)
    assert got["probe_inner"] >= 0.02
    assert got["probe_outer"] >= got["probe_inner"] + 0.01
    assert got["probe_outer.self"] == pytest.approx(
        got["probe_outer"] - got["probe_inner"])


def _profiled_span(tmp_path, device, op):
    """(the chrome trace's events, spans.json) of a profiled window with
    recording on, one span around `op` on `device`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    a = torch.randn(256, 256, device=device)
    with torch.profiler.profile(activities=acts) as prof, \
            plog.recording() as rec:
        with plog.span("probe_clock"):
            op(a)
            if device == "cuda":
                torch.cuda.synchronize()
    trace = str(tmp_path / "trace.json")
    prof.export_chrome_trace(trace)
    rec.write(str(tmp_path / "spans.json"), trace)
    with open(trace) as fh:
        events = json.load(fh)["traceEvents"]
    with open(tmp_path / "spans.json") as fh:
        return events, json.load(fh)


def _inside(event, record):
    return (record["ts"] <= event["ts"]
            and event["ts"] + event["dur"] <= record["ts"] + record["dur"])


def test_span_encloses_its_op_on_the_profiler_clock(tmp_path):
    """In a CPU-profiled window with recording on, the span's record
    (time.time_ns, set on the trace's clock by its baseTimeNanoseconds)
    encloses the profiler's own event of the op run inside it, and the
    span's record_function event lies within the record."""
    events, spans = _profiled_span(tmp_path, "cpu", lambda a: a @ a)
    (rec,) = [r for r in spans["spans"] if r["name"] == "probe_clock"]
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert mm and all(_inside(e, rec) for e in mm)
    (own,) = [e for e in events if e.get("name") == "probe_clock"
              and e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation"]
    assert _inside(own, rec)


@pytest.mark.cuda
def test_span_encloses_its_kernel_on_the_device_clock(tmp_path):
    """The same on a card: the matmul's kernel in the trace's device
    timeline lies inside the span's record."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    events, spans = _profiled_span(tmp_path, "cuda", lambda a: a @ a)
    (rec,) = [r for r in spans["spans"] if r["name"] == "probe_clock"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert kernels and all(_inside(e, rec) for e in kernels)
