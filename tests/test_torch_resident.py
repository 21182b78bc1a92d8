"""The resident store (spacepharer_tpu_torch/ops/resident.py): one device
copy of each catalog per process, keyed by the catalog's SetDB object and
the parameters that shape its arrays, evicted least recently used under a
byte budget; and the dense and card routes reading it over calls in a row
(the golden bundle: result.tsv byte for byte on every call)."""
import glob
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from spacepharer_tpu_torch import logging as plog
from spacepharer_tpu_torch.io.setdb import SetDB
from spacepharer_tpu_torch.ops import prefilter_dense as pd
from spacepharer_tpu_torch.ops import resident, sw_packed
from spacepharer_tpu_torch.ops.matrices import load_matrix
from spacepharer_tpu_torch.ops.prefilter import (PrefilterParams,
                                                 build_masked_flat)
from spacepharer_tpu_torch.pipeline import predictmatch as pm


def _golden_paths(golden):
    (qpath,) = {os.path.realpath(p) for p in
                glob.glob(os.path.join(golden, "tmp", "*", "qsetdb"))}
    return qpath, os.path.join(golden, "targets"), \
        os.path.join(golden, "targets_rev")


def _delta(before):
    now = plog.timings()
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v != before.get(k, 0)}


@pytest.fixture
def store():
    s = resident.Store()
    yield s
    s.release()


class _Catalog:
    """Stands for a SetDB: the store keys by the object, not its value."""


def _build(n, calls):
    def build():
        calls.append(n)
        return (torch.zeros(n, dtype=torch.uint8),)
    return build


def test_same_owner_gets_the_same_entry(store):
    cat, calls = _Catalog(), []
    before = plog.timings()
    first = store.get(cat, ("dense", True, 8), "cpu", _build(100, calls))
    again = store.get(cat, ("dense", True, 8), "cpu", _build(100, calls))
    got = _delta(before)
    assert again[0] is first[0] and calls == [100]
    assert got["resident_builds"] == 1 and got["resident_hits"] == 1
    assert got["resident_bytes"] == 100 == store.held_bytes()
    assert got["resident_build"] > 0          # the build's span


@pytest.mark.parametrize("other", ["owner", "mask", "span", "device_kind"])
def test_another_owner_or_parameter_misses(store, other):
    """Another object holding the same catalog, another mask or pattern
    span, or another kind of entry: each a build of its own."""
    cat, calls = _Catalog(), []
    key = ("dense", True, "VTML80.out", 8)
    first = store.get(cat, key, "cpu", _build(10, calls))
    owner, params = cat, key
    if other == "owner":
        owner = _Catalog()
    elif other == "mask":
        params = ("dense", False, "VTML80.out", 8)
    elif other == "span":
        params = ("dense", True, "VTML80.out", 7)
    else:
        params = ("pairs",)
    got = store.get(owner, params, "cpu", _build(10, calls))
    assert got[0] is not first[0] and calls == [10, 10]
    assert len(store) == 2


def test_owner_is_held_so_its_id_is_never_reused(store):
    cat = _Catalog()
    cid = id(cat)
    store.get(cat, ("pairs",), "cpu", _build(4, []))
    del cat
    # the store holds the object: no new object can take its id
    assert all(id(_Catalog()) != cid for _ in range(1000))


def test_least_recently_used_goes_first_under_the_budget():
    s = resident.Store(budget_bytes=250)
    a, b, c = _Catalog(), _Catalog(), _Catalog()
    before = plog.timings()
    s.get(a, (), "cpu", _build(100, []))
    s.get(b, (), "cpu", _build(100, []))
    s.get(a, (), "cpu", _build(100, []))      # a is now the newest
    s.get(c, (), "cpu", _build(100, []))      # 300 > 250: b goes
    assert s.held_bytes() == 200 <= s.budget_bytes and len(s) == 2
    calls = []
    s.get(a, (), "cpu", _build(100, calls))
    assert calls == []                        # a stayed
    s.get(b, (), "cpu", _build(100, calls))
    assert calls == [100]                     # b was evicted: built again
    got = _delta(before)
    assert got["resident_builds"] == 4 and got["resident_hits"] == 2
    assert got["resident_bytes"] == s.held_bytes() == 200
    s.release()


def test_an_entry_over_the_budget_is_returned_not_kept():
    s = resident.Store(budget_bytes=50)
    cat, calls = _Catalog(), []
    first = s.get(cat, (), "cpu", _build(80, calls))
    assert first[0].numel() == 80 and len(s) == 0 and s.held_bytes() == 0
    s.get(cat, (), "cpu", _build(80, calls))
    assert calls == [80, 80]


def test_release_frees_every_entry():
    s = resident.Store()
    before = plog.timings()
    for n in (10, 20, 30):
        s.get(_Catalog(), (), "cpu", _build(n, []))
    assert s.held_bytes() == 60
    s.release()
    assert len(s) == 0 and s.held_bytes() == 0
    assert _delta(before).get("resident_bytes", 0) == 0


def test_default_budgets():
    s = resident.Store()
    assert s.budget(torch.device("cpu")) == resident.CPU_BUDGET_BYTES
    assert resident.Store(budget_bytes=7).budget(torch.device("cpu")) == 7


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_boundary_valid_matches_host_mask(seed):
    """The valid-position mask built on the device from the starts is
    the host's target_boundary_valid, False past the target's end."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 20, 40)
    lens[:3] = (0, 1, 8)
    starts = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    t_res = int(starts[-1])
    got = pd.boundary_valid(torch.from_numpy(starts), t_res,
                            t_res + pd.TILE_T, 8).numpy()
    assert not got[t_res:].any()
    np.testing.assert_array_equal(got[:t_res],
                                  pd.target_boundary_valid(starts, 8))


@pytest.fixture(scope="module")
def golden_dbs(golden):
    dbs = tuple(SetDB.load(p) for p in _golden_paths(golden))
    with open(os.path.join(golden, "result.tsv")) as fh:
        return dbs, fh.read()


def _dense_args(qdb, tdb, params):
    t_flat, t_off = tdb.orf_aa_encoded()
    masked = build_masked_flat(None, params, packed=(t_flat, t_off))
    q_flat, q_off = qdb.orf_aa_encoded()
    q_all = [q_flat[q_off[k]:q_off[k + 1]] for k in range(qdb.n_orfs)]
    return (q_all, list(range(qdb.n_orfs)), None, masked[0], masked[1],
            params, load_matrix(params.seed_matrix, 8.0),
            load_matrix(params.ungapped_matrix, 2.0))


@pytest.mark.parametrize("other", ["setdb", "mask", "span"])
def test_dense_route_keys_the_catalog(golden, golden_dbs, other):
    """device_prefilter_arrays on the CPU with the catalog named: the
    first search builds its target, the next reads it, and each gives
    the arrays of a search without the store; another SetDB object of
    the same catalog, the mask off, or another pattern span builds anew."""
    (qdb, tdb, _), _ = golden_dbs
    params = PrefilterParams(engine="device")
    args = _dense_args(qdb, tdb, params)
    want = pd.device_prefilter_arrays(*args, device="cpu")
    owner = SetDB.load(_golden_paths(golden)[1])
    before = plog.timings()
    runs = [pd.device_prefilter_arrays(*args, device="cpu", catalog=owner)
            for _ in range(2)]
    got = _delta(before)
    assert got["resident_builds"] == 1 and got["resident_hits"] == 1
    for run in runs:
        for a, b in zip(run, want):
            np.testing.assert_array_equal(a, b)
    if other == "setdb":
        owner2, args2 = SetDB.load(_golden_paths(golden)[1]), args
    else:
        owner2 = owner
        p2 = (replace(params, mask=False) if other == "mask"
              else replace(params, spaced_pattern="1110111"))
        args2 = _dense_args(qdb, tdb, p2)
    before = plog.timings()
    out = pd.device_prefilter_arrays(*args2, device="cpu", catalog=owner2)
    assert _delta(before)["resident_builds"] == 1
    for a, b in zip(out, pd.device_prefilter_arrays(*args2, device="cpu")):
        np.testing.assert_array_equal(a, b)
    resident.release()


def test_dense_cpu_route_twice_in_one_process(golden_dbs):
    """predict_match on the dense route's plain CPU version, two calls in
    a row with the same SetDBs: the golden result.tsv both times; the
    first call builds each catalog's target (forward and control), the
    second reads both and builds none."""
    (qdb, tdb, cdb), text = golden_dbs
    resident.release()
    params = pm.PredictParams(prefilter=PrefilterParams(engine="device"),
                              use_tpu=False, device="cpu")
    deltas = []
    for _ in range(2):
        before = plog.timings()
        res = pm.predict_match(qdb, tdb, cdb, params)
        deltas.append(_delta(before))
        assert res.text == text
    assert deltas[0]["resident_builds"] == 2
    assert "resident_hits" not in deltas[0]
    assert "resident_builds" not in deltas[1]
    assert deltas[1]["resident_hits"] == 2
    assert "dense_target_valid" not in deltas[1]
    resident.release()


def test_spans_json_shows_when_a_catalog_was_uploaded(golden_dbs,
                                                      tmp_path):
    """--trace-dir's spans.json over two dense calls in a row: the first
    holds a resident_build span inside each search's dense pass and the
    counters of two builds, the second only the hits."""
    import json
    (qdb, tdb, cdb), text = golden_dbs
    resident.release()
    spans = []
    for i in range(2):
        params = pm.PredictParams(
            prefilter=PrefilterParams(engine="device"), use_tpu=False,
            device="cpu", trace_dir=str(tmp_path / str(i)))
        assert pm.predict_match(qdb, tdb, cdb, params).text == text
        spans.append(json.loads((tmp_path / str(i) / "spans.json")
                                .read_text()))
    first, second = spans
    by_id = {r["id"]: r for r in first["spans"]}
    builds = [r for r in by_id.values() if r["name"] == "resident_build"]
    assert len(builds) == 2
    assert all(by_id[r["parent"]]["name"] == "dense_pass" for r in builds)
    assert first["counters"]["resident_builds"] == 2
    assert first["counters"]["resident_bytes"] > 0
    assert "resident_hits" not in first["counters"]
    assert not [r for r in second["spans"] if r["name"] == "resident_build"]
    assert second["counters"]["resident_hits"] == 2
    assert "resident_builds" not in second["counters"]
    resident.release()


# ---------------------------------------------------------------- on a card

def _catalog_bytes(db, params, card_route):
    """The bytes a catalog's resident entries upload: the dense target's
    padded letters and starts, and on the card route the pair kernel's
    padded letters and offsets."""
    t_res, n = int(db.orf_aa_offsets[-1]), db.n_orfs
    out = t_res + pd.TILE_T + params.prefilter.pattern_span - 1 + 8 * (n + 1)
    if card_route:
        out += t_res + sw_packed.T_PAD + 8 * (n + 1)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["dense", "card"])
def test_cuda_second_call_uploads_only_the_query_side(golden_dbs, route):
    """On a card, two golden calls in a row on the dense route (--use-tpu
    0) and the card route (--use-tpu 1): the golden result.tsv both
    times; the first call uploads each catalog once, the second none of
    them, so its h2d_bytes is the first's less the catalogs' bytes, all
    query side; the third uploads what the second did."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    (qdb, tdb, cdb), text = golden_dbs
    resident.release()
    params = pm.PredictParams(prefilter=PrefilterParams(engine="device"),
                              use_tpu=route == "card")
    deltas = []
    for _ in range(3):
        before = plog.timings()
        res = pm.predict_match(qdb, tdb, cdb, params)
        torch.cuda.synchronize()
        deltas.append(_delta(before))
        assert res.text == text
    entries = 2 if route == "card" else 1
    assert deltas[0]["resident_builds"] == 2 * entries
    assert "resident_builds" not in deltas[1]
    assert deltas[1]["resident_hits"] == 2 * entries
    catalogs = sum(_catalog_bytes(db, params, route == "card")
                   for db in (tdb, cdb))
    assert deltas[0]["h2d_bytes"] - deltas[1]["h2d_bytes"] == catalogs
    assert deltas[1]["h2d_bytes"] == deltas[2]["h2d_bytes"] > 0
    assert deltas[0]["resident_bytes"] == resident._store.held_bytes()
    resident.release()
