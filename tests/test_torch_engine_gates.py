"""The port's dense-prefilter gate and its `auto` route.

dense_prefilter_viable's device terms were measured on an H100 (the
constants in spacepharer_tpu_torch/pipeline/predictmatch.py). These
tests pin its DECISIONS for the shapes of
tests/test_engine_gates.py::TestDensePrefilterGate, and check that
search_setdbs' `auto` route asks the gate before it probes for a card.
"""
import glob
import os

import pytest

from spacepharer_tpu_torch.io.setdb import SetDB
from spacepharer_tpu_torch.ops import prefilter_dense
from spacepharer_tpu_torch.pipeline import predictmatch as pm


@pytest.mark.parametrize("nk_total,t_res,has_idx,dense", [
    # the two shapes chip_smoke.py phase 4(d) measured in fresh processes
    # (fresh index): the dense route took 30.3 s and 13.3 s against the
    # host walk's 6.8 s and 4.2 s
    pytest.param(94_223, 6_919_175, False, False, id="phase3_corpus"),
    pytest.param(2_149, 6_919_175, False, False, id="phase3_small_side"),
    # a few spacer sets against a fresh half-gigabase target (the JAX
    # package goes dense here): the dense route's host work per target
    # residue exceeds the postings build's
    pytest.param(2_000, 500_000_000, False, False, id="few_kmers_5e8"),
    # x500-corpus shape (37M residues, fresh)
    pytest.param(2_000, 50_000_000, False, False, id="few_kmers_5e7"),
    # catalog query side (870k k-mers)
    pytest.param(870_000, 7_400_000, False, False, id="catalog_queries"),
    # both sides of the TPU's 32k-row compile cap (the JAX package goes
    # dense just below it); the card has no such cap, the host work
    # decides
    pytest.param((1 << 15) + 1, 3 * 10 ** 8, False, False, id="rows_2e15p1"),
    pytest.param(1 << 15, 3 * 10 ** 8, False, False, id="rows_2e15"),
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

    def match_pairs(*a, device):
        devices.append(device)
        return orig(*a, device="cpu")

    orig = prefilter_dense.match_pairs
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
