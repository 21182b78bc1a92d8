"""The port's engine gates and their `auto` routes.

Every term of dense_prefilter_viable and device_scoring_engages was
measured on an H100's machine by chip_smoke.py (the constants in
spacepharer_tpu_torch/pipeline/predictmatch.py). These tests pin their
DECISIONS: the dense gate's for the shapes of
tests/test_engine_gates.py::TestDensePrefilterGate, the scoring gate's
on each side of its threshold, and that search_setdbs' `auto` routes ask
each gate before they probe for a card.
"""
import glob
import os

import pytest

from spacepharer_tpu_torch.io.setdb import SetDB
from spacepharer_tpu_torch.ops import prefilter_dense
from spacepharer_tpu_torch.pipeline import predictmatch as pm


@pytest.mark.parametrize("nk_total,t_res,has_idx,dense", [
    # the four shapes chip_smoke.py phase 4(d) measured in fresh processes
    # (fresh index), where the host route was the faster at each
    pytest.param(94_223, 6_919_175, False, False, id="phase3_corpus"),
    pytest.param(2_149, 6_919_175, False, False, id="phase3_small_side"),
    pytest.param(942_230, 6_919_175, False, False, id="phase3_queries_x10"),
    pytest.param(94_223, 20_746_310, False, False, id="phase3_targets_x3"),
    # a few spacer sets against a fresh half-gigabase target (the JAX
    # package goes dense here too): the postings build the host route
    # would pay outweighs the dense route's fixed cost (an extrapolation
    # of the per-residue terms, PERF.md)
    pytest.param(2_000, 500_000_000, False, True, id="few_kmers_5e8"),
    # x500-corpus shape (37M residues, fresh): the fixed cost decides
    pytest.param(2_000, 50_000_000, False, False, id="few_kmers_5e7"),
    # catalog query side (870k k-mers): the dense product's seconds
    pytest.param(870_000, 7_400_000, False, False, id="catalog_queries"),
    # both sides of the TPU's 32k-row compile cap (the JAX package goes
    # dense just below it); the card has no such cap: both go dense on a
    # fresh 3e8-residue target, whose postings build decides
    pytest.param((1 << 15) + 1, 3 * 10 ** 8, False, True, id="rows_2e15p1"),
    pytest.param(1 << 15, 3 * 10 ** 8, False, True, id="rows_2e15"),
    # a persisted index makes the host walk nearly free
    pytest.param(2_000, 500_000_000, True, False, id="persisted_index"),
    # huge dense products are cut off by estimated seconds
    pytest.param(30_000, 10 ** 12, False, False, id="huge_product"),
])
def test_dense_gate_decisions(nk_total, t_res, has_idx, dense):
    assert pm.dense_prefilter_viable(nk_total, t_res, has_idx) is dense


@pytest.fixture(scope="module")
def golden_dbs(golden):
    (qpath,) = {os.path.realpath(p) for p in
                glob.glob(os.path.join(golden, "tmp", "*", "qsetdb"))}
    return SetDB.load(qpath), SetDB.load(os.path.join(golden, "targets"))


def _route(monkeypatch, golden_dbs, viable, use_tpu=None):
    """Run one search of the golden queries with the gate forced to
    `viable` and a card reported present; returns the dense pass's
    devices (empty: the host prefilter ran) and the gate's calls."""
    gate_calls, devices = [], []

    def gate(nk_total, t_res, has_idx):
        gate_calls.append((nk_total, t_res, has_idx))
        return viable

    def match_pairs(*a, device, **kw):
        devices.append(device)
        return orig(*a, device="cpu", **kw)

    def dense_target(*a, **kw):    # the target goes where match_pairs runs
        return orig_target(*a[:3], "cpu", **kw)

    orig = prefilter_dense.match_pairs
    orig_target = prefilter_dense.dense_target
    monkeypatch.setattr(prefilter_dense, "dense_target", dense_target)
    monkeypatch.setattr(pm, "dense_prefilter_viable", gate)
    monkeypatch.setattr(pm, "_accelerator_present", lambda: True)
    monkeypatch.setattr(prefilter_dense, "match_pairs", match_pairs)
    qdb, tdb = golden_dbs
    params = pm.PredictParams(use_tpu=use_tpu, perform_nucl_aln=False)
    pm.search_setdbs(qdb, tdb, params)
    return devices, gate_calls


def test_auto_route_takes_the_card_when_the_gate_passes(monkeypatch,
                                                        golden_dbs):
    devices, gate_calls = _route(monkeypatch, golden_dbs, viable=True)
    assert devices == ["cuda"]
    assert len(gate_calls) == 1


def test_auto_route_stays_on_host_when_the_gate_fails(monkeypatch,
                                                      golden_dbs):
    devices, gate_calls = _route(monkeypatch, golden_dbs, viable=False)
    assert devices == [] and len(gate_calls) == 1


def test_use_tpu_0_keeps_auto_off_the_card(monkeypatch, golden_dbs):
    devices, gate_calls = _route(monkeypatch, golden_dbs, viable=True,
                                 use_tpu=False)
    assert devices == [] and gate_calls == []


@pytest.mark.parametrize("cells,engages", [
    # the golden bundle, and every shape chip_smoke.py phase 3(b) has
    # measured (the query side x1, x3, x10 and x30, and phase 3's query
    # side against 3x the target genomes), where the host engine's search
    # stage was the faster and the fitted lines cross only far beyond
    # them (1.36e10 cells)
    pytest.param(26_100, False, id="golden"),
    pytest.param(82_039_218, False, id="phase3_corpus"),
    pytest.param(246_117_654, False, id="phase3_corpus_x3"),
    pytest.param(820_392_180, False, id="phase3_corpus_x10"),
    pytest.param(2_461_176_540, False, id="phase3_corpus_x30"),
    pytest.param(240_134_098, False, id="phase3_targets_x3"),
    # where the fitted lines cross
    pytest.param(1.36e10, False, id="fitted_crossing"),
    # just above the TPU's break-even (3e10), where `auto` used to send
    # a search on a card to the GPU engine
    pytest.param(3e10 + 1, False, id="tpu_break_even"),
    # on each side of the threshold
    pytest.param(1e12, False, id="at_threshold"),
    pytest.param(1e12 + 1, True, id="above_threshold"),
])
def test_scoring_gate_decisions(cells, engages):
    assert pm.device_scoring_engages(None, None, cells,
                                     accel_present=lambda: True) is engages


def test_scoring_gate_needs_a_card_and_yields_to_flags():
    def boom():
        raise AssertionError("the card probe ran below the threshold")

    assert not pm.device_scoring_engages(None, None, 1e13,
                                         accel_present=lambda: False)
    assert not pm.device_scoring_engages(None, None, 1e6,
                                         accel_present=boom)
    assert pm.device_scoring_engages(True, None, 0, accel_present=boom)
    assert pm.device_scoring_engages(None, (2, 4), 0, accel_present=boom)
    assert not pm.device_scoring_engages(False, None, 1e30,
                                         accel_present=boom)


def _scoring_route(monkeypatch, golden_dbs, threshold=None):
    """One search of the golden queries under `auto`, a card reported
    present and the host prefilter: the candidate cells the scoring gate
    saw and whether the GPU engine (_search_tpu) ran."""
    seen, ran = [], []
    gate = pm.device_scoring_engages

    def watched(use_tpu, mesh, cells, accel_present=None):
        seen.append(cells)
        return gate(use_tpu, mesh, cells, accel_present)

    def engine(keys, *a, **kw):
        ran.append(len(keys))
        return {k: [] for k in keys}

    monkeypatch.setattr(pm, "device_scoring_engages", watched)
    monkeypatch.setattr(pm, "_accelerator_present", lambda: True)
    monkeypatch.setattr(pm, "_search_tpu", engine)
    if threshold is not None:
        monkeypatch.setattr(pm, "_DEVICE_CELLS_THRESHOLD", threshold)
    qdb, tdb = golden_dbs
    params = pm.PredictParams(
        perform_nucl_aln=False,
        prefilter=pm.PrefilterParams(engine="host"))
    pm.search_setdbs(qdb, tdb, params)
    return seen, ran


def test_auto_scoring_route_keeps_the_host_engine(monkeypatch, golden_dbs):
    seen, ran = _scoring_route(monkeypatch, golden_dbs)
    assert len(seen) == 1 and 0 < seen[0] <= pm._DEVICE_CELLS_THRESHOLD
    assert ran == []


def test_auto_scoring_route_takes_the_card_above_threshold(monkeypatch,
                                                           golden_dbs):
    seen, ran = _scoring_route(monkeypatch, golden_dbs, threshold=1000)
    assert len(seen) == 1 and seen[0] > 1000
    assert ran == [golden_dbs[0].n_orfs]


# ------------------------------------- the torch probe beside the host walk

@pytest.mark.parametrize("use_tpu,threshold,started", [
    pytest.param(False, 1e5, False, id="use_tpu_0"),
    # the golden ceiling (~1e8 cells) lies under the threshold in the code
    pytest.param(None, None, False, id="ceiling_under_threshold"),
    pytest.param(None, 1e5, True, id="ceiling_over_threshold"),
    pytest.param(True, None, True, id="use_tpu_1"),
])
def test_torch_probe_starts_only_when_the_card_could_score(
        monkeypatch, golden_dbs, use_tpu, threshold, started):
    """search_setdbs starts the probe thread before the host walk only
    when use_tpu is not False and either use_tpu is set or the a-priori
    cell ceiling is above _DEVICE_CELLS_THRESHOLD."""
    starts = []
    monkeypatch.setattr(pm, "_start_torch_probe", lambda: starts.append(1))
    if threshold is not None:
        monkeypatch.setattr(pm, "_DEVICE_CELLS_THRESHOLD", threshold)
    qdb, tdb = golden_dbs
    pm.search_setdbs(qdb, tdb, pm.PredictParams(use_tpu=use_tpu,
                                                perform_nucl_aln=False,
                                                device="cpu"))
    assert starts == ([1] if started else [])


def test_torch_probe_answers_the_card_probe(monkeypatch):
    """The thread imports torch and probes; _accelerator_present joins it
    and gives its answer, and a second start is a no-op."""
    import torch
    monkeypatch.setattr(pm, "_torch_probe", None)
    pm._start_torch_probe()
    probe = pm._torch_probe
    pm._start_torch_probe()
    assert pm._torch_probe is probe
    assert pm._accelerator_present() is torch.cuda.is_available()
    thread, result = probe
    assert not thread.is_alive()
    assert result["seconds"] >= 0 and result["waited"] >= 0


class _RunningProbe:
    """A probe thread that runs until joined; records the join."""

    def __init__(self, events):
        self.events, self.alive = events, True

    def is_alive(self):
        return self.alive

    def join(self):
        self.events.append("join")
        self.alive = False


def test_forks_wait_for_the_torch_probe(monkeypatch):
    """No fork while the probe thread runs: _run_keyed's fork pool and
    _fork_reverse_search join it first."""
    events = []
    real_fork = os.fork

    def fork():
        events.append("fork")
        return real_fork()

    monkeypatch.setattr(os, "fork", fork)
    monkeypatch.setattr(pm, "_torch_probe",
                        (_RunningProbe(events), {"present": False}))
    out = pm._run_keyed(lambda k: k * 2, list(range(40)), 2, True)
    assert out == {k: k * 2 for k in range(40)}
    assert events[0] == "join" and events.count("fork") >= 2

    class Cache:
        def has(self, name):
            return False

        def flush(self):
            pass

    events.clear()
    monkeypatch.setattr(os, "fork", lambda: events.append("fork") or 4242)
    monkeypatch.setattr(pm, "_torch_probe",
                        (_RunningProbe(events), {"present": False}))
    assert pm._fork_reverse_search(Cache(), None, None,
                                   pm.PredictParams()) == 4242
    assert events == ["join", "fork"]


def test_host_engine_text_unchanged_beside_the_probe(monkeypatch, golden):
    """A search that `auto` sends to the host engine while the probe runs
    (the ceiling over a lowered threshold, the candidate cells under it):
    the golden bytes, the probe started, and no card probe asked of it."""
    (qpath,) = {os.path.realpath(p) for p in
                glob.glob(os.path.join(golden, "tmp", "*", "qsetdb"))}
    dbs = [SetDB.load(p) for p in (qpath, os.path.join(golden, "targets"),
                                   os.path.join(golden, "targets_rev"))]

    def never(*a, **kw):
        raise AssertionError("the host route asked the card")

    monkeypatch.setattr(pm, "_torch_probe", None)
    monkeypatch.setattr(pm, "_DEVICE_CELLS_THRESHOLD", 1e5)
    monkeypatch.setattr(pm, "_accelerator_present", never)
    monkeypatch.setattr(pm, "_search_tpu", never)
    res = pm.predict_match(*dbs, pm.PredictParams())
    with open(os.path.join(golden, "result.tsv")) as fh:
        assert res.text == fh.read()
    assert pm._torch_probe is not None
    pm._torch_probe[0].join()
