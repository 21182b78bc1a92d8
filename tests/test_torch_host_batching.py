"""The host work behind the port's device routes, batched over keys,
against the JAX package's per-key code on the same inputs.

- `_search_tpu` (the GPU engine's and the mesh's host half): biases per
  key block, one vectorized E-value screen, and the survivors through
  align_query_batch. Held on the golden DBs and on a small mutated corpus
  (chip_smoke.build_corpus at a CPU size: 2 % substituted copies of each
  golden genome and random spacer sets), with the torch scan engine and
  the mesh at (2, 2), both asked for on the CPU, and the GPU engine's
  card branch on CPU tensors (its bias built with the query profiles, no
  host bias); with max_accept=1 the per-key path.
- The dense route's alignment through align_query_batch.
- `hits_to_streams` over every key and row at once.
- `_query_bias_i8` against `sw_bias_i8`, its rounding at +-0.5
  included, and `_key_blocks` against the per-key block loop.
"""
import glob
import os
from dataclasses import replace

import numpy as np
import pytest

import chip_smoke
from spacepharer_tpu.io.setdb import SetDB as JaxSetDB
from spacepharer_tpu.ops import align as jax_align
from spacepharer_tpu.ops import prefilter_dense as jax_pd
from spacepharer_tpu.ops.evalue import EvalueComputer as JaxEvalue
from spacepharer_tpu.ops.evalue import gumbel_params as jax_gumbel
from spacepharer_tpu.ops.matrices import load_matrix as jax_load_matrix
from spacepharer_tpu.ops.prefilter import \
    SimilarKmerEnumerator as JaxEnumerator
from spacepharer_tpu.pipeline import predictmatch as jax_pm
from spacepharer_tpu_torch.io.setdb import SetDB
from spacepharer_tpu_torch.native import get_lib
from spacepharer_tpu_torch.ops import align
from spacepharer_tpu_torch.ops import bias as bias_mod
from spacepharer_tpu_torch.ops import prefilter_dense as pd
from spacepharer_tpu_torch.ops.bias import expected_score_tab
from spacepharer_tpu_torch.ops.matrices import load_matrix
from spacepharer_tpu_torch.ops.prefilter import (PrefilterParams,
                                                 SimilarKmerEnumerator)
from spacepharer_tpu_torch.pipeline import predictmatch as pm


def _golden_paths(golden):
    (qpath,) = {os.path.realpath(p) for p in
                glob.glob(os.path.join(golden, "tmp", "*", "qsetdb"))}
    return [qpath, os.path.join(golden, "targets")]


@pytest.fixture(scope="module")
def corpora(golden, tmp_path_factory):
    """{name: (query path, target path)}: the golden DBs, and a mutated
    corpus built as chip_smoke.py phase 3 builds its own, cut to 4
    copies of each golden genome and 30 random spacer sets."""
    base = str(tmp_path_factory.mktemp("corpus"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "COPIES", 4)
        mp.setattr(chip_smoke, "SETS", 30)
        mp.setattr(chip_smoke, "SMALL_SETS", 1)
        paths = chip_smoke.build_corpus(golden, base, seed=0)
    return {"golden": _golden_paths(golden),
            "mutated": paths["host"][:2]}


_captured = {}


def _search_inputs(corpora, name):
    """The arguments search_setdbs hands _search_tpu on a corpus (the
    GPU engine forced on), captured once per corpus."""
    if name not in _captured:
        got = []

        def capture(*args, **kw):
            got.append(args)
            return {}

        qpath, tpath = corpora[name]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pm, "_search_tpu", capture)
            pm.search_setdbs(SetDB.load(qpath), SetDB.load(tpath),
                             pm.PredictParams(use_tpu=True,
                                              perform_nucl_aln=False,
                                              device="cpu"))
        (_captured[name],) = got
    return _captured[name]


def _jax_side(args, jparams):
    """JAX's _search_tpu on the same inputs (its own matrix, E-value
    computer and parameters; candidates as per-key lists)."""
    keys, t_aa, (t_flat, t_off), (cand_t, cand_off), q_all, _, _, _ = args
    cand = {k: cand_t[cand_off[i]:cand_off[i + 1]].tolist()
            for i, k in enumerate(keys)}
    a = jparams.align
    m40 = jax_load_matrix(a.matrix, 2.0)
    ev = JaxEvalue(jax_gumbel(a.matrix, a.gap_open, a.gap_extend),
                   int(t_off[-1]))
    return jax_pm._search_tpu(keys, t_aa, cand, q_all, m40, ev, jparams)


def _port_side(args, **align_kw):
    keys, t_aa, t_packed, cand, q_all, m40, evaluer, params = args
    params = replace(params, align=replace(params.align, **align_kw))
    return pm._search_tpu(keys, t_aa, t_packed, cand, q_all, m40, evaluer,
                          params)


def _no_per_pair_alignment(mp):
    """The batched path computes no bias and aligns no pair on its own."""
    def boom(*a, **kw):
        raise AssertionError("per-key host work on the batched path")
    mp.setattr(align, "sw_bias_i8", boom)
    mp.setattr(align, "sw_align", boom)


def _card_on_cpu(mp):
    """Report a card and run the GPU engine's pair entry on CPU tensors
    (the plain versions of its kernels); the host bias raises."""
    from spacepharer_tpu_torch.ops import sw_packed
    real = sw_packed.device_pair_scores

    def host_bias(*a, **kw):
        raise AssertionError("the card branch built the bias on the host")

    mp.setattr(pm, "_accelerator_present", lambda: True)
    mp.setattr(pm, "_query_bias_i8", host_bias)
    mp.setattr(sw_packed, "device_pair_scores",
               lambda *a, device, **kw: real(*a, device="cpu", **kw))


# route -> (mesh, the scoring engine on the card's branch)
ROUTES = {"scan": (None, False), "mesh22": ((2, 2), False),
          "card": (None, True)}


def _on_route(args, route, mp):
    """args with the route's mesh and device; the card branch patched in
    on CPU tensors."""
    mesh, card = ROUTES[route]
    if card:
        _card_on_cpu(mp)
    return args[:-1] + (replace(args[-1], mesh=mesh,
                                device="cuda" if card else "cpu"),)


@pytest.mark.parametrize("name", ["golden", "mutated"])
@pytest.mark.parametrize("mesh", list(ROUTES))
def test_search_tpu_matches_jax(corpora, name, mesh):
    with pytest.MonkeyPatch.context() as mp:
        args = _on_route(_search_inputs(corpora, name), mesh, mp)
        _no_per_pair_alignment(mp)
        got = _port_side(args)
    want = _jax_side(args, jax_pm.PredictParams(use_tpu=True,
                                                mesh=ROUTES[mesh][0]))
    assert got == want
    n_rows = sum(len(r) for r in got.values())
    assert n_rows >= (6 if name == "golden" else 40)


@pytest.mark.parametrize("name", ["golden", "mutated"])
def test_search_tpu_per_key_path_matches_jax(corpora, name):
    """max_accept=1 keeps the per-key realignment, which (like the JAX
    package's) ignores the acceptance caps."""
    args = _search_inputs(corpora, name)
    got = _port_side(args, max_accept=1)
    jparams = jax_pm.PredictParams(use_tpu=True)
    jparams.align.max_accept = 1
    assert got == _jax_side(args, jparams)
    assert max(len(r) for r in got.values()) > 1


def test_search_tpu_on_the_evalue_cutoff(corpora):
    """The E-value cutoff set exactly to the largest E-value that passes
    the default one: the vectorized screen keeps that pair as the JAX
    package's scalar screen does, and both drop it one ulp lower."""
    args = _search_inputs(corpora, "mutated")
    keys, t_aa, _, (cand_t, cand_off), q_all, m40, evaluer, params = args
    q_list = [q_all[k] for k in keys]
    scores = pm._candidate_scores(q_list, t_aa, cand_t, cand_off,
                                  pm._query_bias_i8(q_list, m40), m40,
                                  params)
    pair_q = np.repeat(np.arange(len(keys)), np.diff(cand_off))
    evs = np.array([float(evaluer.evalue(int(s), len(q_list[q])))
                    for s, q in zip(scores.tolist(), pair_q.tolist())])
    cut = float(evs[evs <= params.align.evalue].max())
    n = []
    for ev_max in (cut, float(np.nextafter(cut, 0))):
        got = _port_side(args, evalue=ev_max)
        jparams = jax_pm.PredictParams(use_tpu=True)
        jparams.align.evalue = ev_max
        assert got == _jax_side(args, jparams)
        n.append(sum(len(r) for r in got.values()))
    assert n[0] > n[1]


def test_screen_equals_the_scalar_screen():
    rng = np.random.default_rng(3)
    ev = pm.EvalueComputer(pm.gumbel_params("VTML40.out", 16, 2), 10 ** 7)
    q_lens = rng.integers(8, 40, 50)
    cand_off = np.concatenate(([0], np.cumsum(rng.integers(0, 30, 50))))
    scores = rng.integers(0, 120, int(cand_off[-1]))
    pair_q = np.repeat(np.arange(50), np.diff(cand_off))
    scalar = np.array([float(ev.evalue(int(s), int(q_lens[q])))
                       for s, q in zip(scores, pair_q)])
    for cut in (scalar[7], scalar[100], 200.0, np.nextafter(scalar[7], 0)):
        keep = pm._evalue_screen(scores, q_lens, cand_off, ev, cut)
        np.testing.assert_array_equal(keep, scalar <= cut)


@pytest.mark.parametrize("mesh", list(ROUTES))
def test_device_scores_equal_native_forward(corpora, mesh, monkeypatch):
    """Every candidate's score from the device engine (int8 bias from
    _query_bias_i8 on the mesh and the scan, from the profile build on
    the card's branch) equals the native forward pass of
    align_query_batch (its bias from the expected-score table), so the
    survivors the screen hands on keep their score and E-value."""
    lib = get_lib()
    if lib is None:
        pytest.skip("native library unavailable")
    keys, t_aa, (t_flat, t_off), (cand_t, cand_off), q_all, m40, _, _ \
        = _search_inputs(corpora, "mutated")
    q_list = [q_all[k] for k in keys]
    biases = pm._query_bias_i8(q_list, m40)
    *_, params = _on_route(_search_inputs(corpora, "mutated"), mesh,
                           monkeypatch)
    dev = pm._candidate_scores(q_list, t_aa, cand_t, cand_off,
                               None if ROUTES[mesh][1] else biases, m40,
                               params)
    qstarts = np.zeros(len(q_list) + 1, dtype=np.int64)
    np.cumsum([len(q) for q in q_list], out=qstarts[1:])
    qflat = np.ascontiguousarray(np.concatenate(q_list), dtype=np.uint8)
    sub32 = np.ascontiguousarray(m40.scores, dtype=np.int32)
    etab = np.ascontiguousarray(expected_score_tab(m40))
    tf = np.ascontiguousarray(t_flat, dtype=np.uint8)
    ts = np.ascontiguousarray(t_off, dtype=np.int64)
    ct = np.ascontiguousarray(cand_t, dtype=np.int32)
    co = np.ascontiguousarray(cand_off, dtype=np.int64)
    n = len(ct)
    score, tend, qend = (np.empty(n, dtype=np.int32) for _ in range(3))
    lib.align_forward_batch(
        qflat.ctypes.data, qstarts.ctypes.data, len(q_list),
        sub32.ctypes.data, sub32.shape[1], etab.ctypes.data, 1,
        tf.ctypes.data, ts.ctypes.data, ct.ctypes.data, co.ctypes.data,
        params.align.gap_open, params.align.gap_extend,
        score.ctypes.data, tend.ctypes.data, qend.ctypes.data)
    np.testing.assert_array_equal(dev, score)
    assert n >= 40


# ------------------------------------------------ the dense route's alignment

@pytest.mark.parametrize("name", ["golden", "mutated"])
def test_dense_route_aligns_in_batches_as_jax(corpora, name, monkeypatch):
    """The dense prefilter route (the kernels' plain versions on the CPU)
    aligns through align_query_batch, never align_query per key, and
    gives the JAX package's dense route's rows."""
    def boom(*a, **kw):
        raise AssertionError("align_query per key on the dense route")

    qpath, tpath = corpora[name]
    params = pm.PredictParams(use_tpu=False, perform_nucl_aln=False,
                              prefilter=PrefilterParams(engine="device"),
                              device="cpu")
    monkeypatch.setattr(pm, "align_query", boom)
    got = pm.search_setdbs(SetDB.load(qpath), SetDB.load(tpath), params)
    jparams = jax_pm.PredictParams(use_tpu=False, perform_nucl_aln=False)
    jparams.prefilter.engine = "device"
    want = jax_pm.search_setdbs(JaxSetDB.load(qpath), JaxSetDB.load(tpath),
                                jparams)
    assert got == want
    assert sum(len(r) for r in got.values()) > 0


# ----------------------------------------------------------- hits_to_streams

def _stream_case(seed, n_queries=12, alphabet=20, n_hits=3000,
                 hit_keys=None):
    """(port batch, JAX batch, gi, gj, flat, starts, seed matrix) of
    random queries over `alphabet` letters (few letters: rows share
    halves) and random hits, many repeated, on keys `hit_keys` (all when
    None) at target positions whose k-mer fits the flat target."""
    rng = np.random.default_rng(seed)
    params = PrefilterParams()
    seed_m = load_matrix(params.seed_matrix, 8.0)
    q_all = [rng.integers(0, alphabet, int(rng.integers(7, 30))).astype(
        np.int64) for _ in range(n_queries)]
    targets = [rng.integers(0, 20, int(rng.integers(20, 200))).astype(
        np.uint8) for _ in range(30)]
    starts = np.concatenate(([0], np.cumsum([len(t) for t in targets])))
    flat = np.concatenate(targets)
    bias80 = [np.zeros(len(q)) for q in q_all]
    keys = list(range(n_queries))
    batch = pd.build_query_batch(q_all, keys, bias80, params)
    jbatch = jax_pd.build_query_batch(q_all, keys, bias80, params)
    rows = np.arange(batch.n_rows)
    if hit_keys is not None:
        ki = np.searchsorted(batch.q_starts, rows, side="right") - 1
        rows = rows[np.isin(ki, hit_keys)]
    gi = rng.choice(rows, n_hits) if len(rows) else np.zeros(0, np.int64)
    gj = rng.integers(0, len(flat) - batch.span, len(gi))
    dup = rng.random(len(gi)) < 0.3             # whole repeated hits
    gi = np.concatenate([gi, gi[dup]])
    gj = np.concatenate([gj, gj[dup]])
    perm = rng.permutation(len(gi))
    return batch, jbatch, gi[perm], gj[perm], flat, starts, seed_m


def _same_streams(got, want):
    assert list(got) == list(want)
    for k in want:
        for a, b in zip(got[k], want[k]):
            assert a.dtype == np.int64
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(5))
def test_hits_to_streams_matches_jax(seed):
    batch, jbatch, gi, gj, flat, starts, seed_m = _stream_case(seed)
    got = pd.hits_to_streams(batch, gi, gj, flat, starts,
                             SimilarKmerEnumerator(seed_m.scores))
    want = jax_pd.hits_to_streams(jbatch, gi, gj, flat, starts,
                                  JaxEnumerator(seed_m.scores))
    _same_streams(got, want)
    assert sum(len(m) for m, _ in got.values()) > 1000


@pytest.mark.parametrize("case", ["empty_keys", "single_key", "no_hits",
                                  "repeated_halves", "rank_chunks",
                                  "lexsort_keys"])
def test_hits_to_streams_edges(case, monkeypatch):
    """Keys without hits, one key, no hit at all, rows over two letters
    (their halves repeat), rank tables stacked 7 at a time, and the
    lexicographic sort that keys too wide for one int64 take."""
    kw = {"empty_keys": dict(hit_keys=[1, 4, 5, 9]),
          "single_key": dict(n_queries=1),
          "no_hits": dict(n_hits=0),
          "repeated_halves": dict(alphabet=2, n_queries=20),
          "rank_chunks": dict(n_queries=40),
          "lexsort_keys": dict(n_queries=30)}[case]
    if case == "rank_chunks":
        monkeypatch.setattr(pd, "RANK_CHUNK", 7)
    if case == "lexsort_keys":
        monkeypatch.setattr(pd, "KEY_BITS", 0)
    batch, jbatch, gi, gj, flat, starts, seed_m = _stream_case(11, **kw)
    got = pd.hits_to_streams(batch, gi, gj, flat, starts,
                             SimilarKmerEnumerator(seed_m.scores))
    want = jax_pd.hits_to_streams(jbatch, gi, gj, flat, starts,
                                  JaxEnumerator(seed_m.scores))
    _same_streams(got, want)
    if case == "empty_keys":
        assert [k for k in got if len(got[k][0])] == [1, 4, 5, 9]


# -------------------------------------------------------- biases and blocks

def test_query_bias_matches_sw_bias_i8(monkeypatch):
    """Length-sorted blocks (a small budget: one long ORF among short
    ones gets a block of its own) give sw_bias_i8 of every query."""
    monkeypatch.setattr(pm, "_BIAS_BLOCK_CELLS", 200)
    rng = np.random.default_rng(5)
    m40 = load_matrix("VTML40.out", 2.0)
    jm40 = jax_load_matrix("VTML40.out", 2.0)
    qs = [rng.integers(0, 21, int(n)).astype(np.int64)
          for n in rng.integers(1, 40, 60)] + [
        rng.integers(0, 20, 500).astype(np.int64)]
    qs.insert(10, qs.pop())
    got = pm._query_bias_i8(qs, m40)
    for q, b in zip(qs, got):
        np.testing.assert_array_equal(b, align.sw_bias_i8(q, m40))
        np.testing.assert_array_equal(b, jax_align.sw_bias_i8(q, jm40))
        assert b.dtype == np.int64


def test_query_bias_rounds_half_away_from_zero(monkeypatch):
    """Unrounded biases at +-0.5, +-1.5, +-2.5 (and beside them) round as
    sw_bias_i8 rounds them."""
    vals = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 0.49999999999999994,
                     -0.49999999999999994, 0.0, -0.0, 3.5000000000000004])

    def fake(q, matrix):
        return vals[:len(q)].copy()

    monkeypatch.setattr(align, "local_aa_bias", fake)
    monkeypatch.setattr(bias_mod, "local_aa_bias_batch",
                        lambda seqs, m: [fake(q, m) for q in seqs])
    m40 = load_matrix("VTML40.out", 2.0)
    qs = [np.zeros(n, dtype=np.int64) for n in (len(vals), 3, 1)]
    for q, b in zip(qs, pm._query_bias_i8(qs, m40)):
        np.testing.assert_array_equal(b, align.sw_bias_i8(q, m40))
    # x +- 0.5 rounds in float first, as (int)(x + 0.5) does in C: the
    # largest double below 0.5 goes to 1
    np.testing.assert_array_equal(pm._query_bias_i8(qs[:1], m40)[0],
                                  [1, -1, 2, -2, 3, -3, 1, -1, 0, 0, 4])


def _greedy_blocks(cand_t, cand_off, max_cells):
    """The per-key block loop _search_tpu used before (and the JAX
    package uses)."""
    blocks, cur, union = [], [], set()
    for k in range(len(cand_off) - 1):
        cur.append(k)
        union.update(cand_t[cand_off[k]:cand_off[k + 1]].tolist())
        if len(cur) * max(len(union), 1) > max_cells:
            blocks.append((cur[0], k + 1))
            cur, union = [], set()
    if cur:
        blocks.append((cur[0], cur[-1] + 1))
    return blocks


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("max_cells", [1, 50, 500, 5e7])
def test_key_blocks_match_the_key_loop(seed, max_cells):
    rng = np.random.default_rng(seed)
    nk = int(rng.integers(1, 400))
    cand_off = np.concatenate(([0], np.cumsum(rng.integers(0, 12, nk))))
    cand_t = rng.integers(0, int(rng.integers(1, 300)), int(cand_off[-1]))
    assert pm._key_blocks(cand_t, cand_off, max_cells) == \
        _greedy_blocks(cand_t, cand_off, max_cells)
