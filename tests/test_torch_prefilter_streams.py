"""The dense prefilter's host half in the port (ops/prefilter_dense.py):
the match-stream rebuild (csrc/prefilter_streams.cu and its plain
versions), the batch finalize (native prefilter_finalize_batch) and the
route's arrays, against the JAX package.

Every quantity is an integer, so every comparison is exact. The CPU cases
run the plain versions and hold them against the JAX package's
hits_to_streams, its SimilarKmerEnumerator.half_rank and its
device_prefilter, and the batch finalize against the per-key native
finalize. The `cuda` cases hold the kernels against the plain versions on
the card. JAX is imported only where the JAX side runs, so the `cuda`
cases also run where JAX is not installed (`pytest -m cuda
tests/test_torch_prefilter_streams.py` on a GPU box).
"""
import os

import numpy as np
import pytest
import torch

from spacepharer_tpu_torch.ops import prefilter_dense as pd
from spacepharer_tpu_torch.ops.matrices import load_matrix
from spacepharer_tpu_torch.ops.prefilter import (
    PrefilterParams, TargetIndex, _finalize_native, build_masked_flat,
    ungapped_profile_cap)
from spacepharer_tpu_torch.pipeline import predictmatch as pm
from test_torch_prefilter_dense import (CUDA_CASES, EDGE_CASES, _case,
                                        _counted, cuda_case)


def stream_case(seed, n_queries=12, alphabet=20, n_hits=3000,
                hit_keys=None, pad_hits=0):
    """(batch, gi int64, gj int64, flat, starts, seed matrix) of random
    queries over `alphabet` letters (few letters: rows share halves) and
    random hits on every row (the last rows' halves read the batch's X
    tail), many repeated, on keys `hit_keys` (all when None), at target
    positions whose k-mer fits the flat target; plus `pad_hits` hits on
    pad rows and past the target, which the rebuild drops."""
    rng = np.random.default_rng(seed)
    params = PrefilterParams()
    seed_m = load_matrix(params.seed_matrix, 8.0)
    q_all = [rng.integers(0, alphabet, int(rng.integers(7, 30))).astype(
        np.int64) for _ in range(n_queries)]
    targets = [rng.integers(0, 20, int(rng.integers(20, 200))).astype(
        np.uint8) for _ in range(30)]
    starts = np.concatenate(([0], np.cumsum([len(t) for t in targets])))
    flat = np.concatenate(targets)
    batch = pd.build_query_batch(q_all, list(range(n_queries)),
                                 [np.zeros(len(q)) for q in q_all], params)
    rows = np.arange(batch.n_rows)
    if hit_keys is not None:
        ki = np.searchsorted(batch.q_starts, rows, side="right") - 1
        rows = rows[np.isin(ki, hit_keys)]
    gi = rng.choice(rows, n_hits) if len(rows) else np.zeros(0, np.int64)
    gj = rng.integers(0, len(flat) - batch.span, len(gi))
    dup = rng.random(len(gi)) < 0.3             # whole repeated hits
    gi = np.concatenate([gi, gi[dup],
                         batch.n_rows + rng.integers(0, 300, pad_hits),
                         rng.integers(0, batch.n_rows, pad_hits)])
    gj = np.concatenate([gj, gj[dup], rng.integers(0, len(flat), pad_hits),
                         len(flat) + rng.integers(0, 700, pad_hits)])
    perm = rng.permutation(len(gi))
    return batch, gi[perm], gj[perm], flat, starts, seed_m


def kept(batch, gi, gj, flat):
    keep = (gi < batch.n_rows) & (gj < len(flat))
    return gi[keep], gj[keep]


def jax_streams(batch, gi, gj, flat, starts, scores):
    """The JAX package's hits_to_streams of the kept hits, as flat
    (m_t, m_d, key offsets)."""
    from spacepharer_tpu.ops import prefilter_dense as jpd
    from spacepharer_tpu.ops.prefilter import SimilarKmerEnumerator
    jb = jpd.build_query_batch(
        [batch.q_flat[batch.q_starts[i]:batch.q_starts[i + 1]]
         for i in range(len(batch.keys))], list(range(len(batch.keys))),
        [np.zeros(batch.q_starts[i + 1] - batch.q_starts[i])
         for i in range(len(batch.keys))], PrefilterParams())
    gi, gj = kept(batch, gi, gj, flat)
    want = jpd.hits_to_streams(jb, gi, gj, flat, starts,
                               SimilarKmerEnumerator(scores))
    m_t = [want[k][0] for k in range(len(batch.keys))]
    m_d = [want[k][1] for k in range(len(batch.keys))]
    off = np.concatenate(([0], np.cumsum([len(m) for m in m_t])))
    return (np.concatenate(m_t).astype(np.int64),
            np.concatenate(m_d).astype(np.int64), off)


def plain_rebuild(batch, gi, gj, flat, starts, scores):
    return pd.rebuild_streams(batch, torch.from_numpy(gi.astype(np.int32)),
                              torch.from_numpy(gj.astype(np.int64)), flat,
                              starts, scores)


def assert_same_streams(got, want):
    m_t, m_d, off = got
    assert m_t.dtype == np.int32 and m_d.dtype == np.uint16
    np.testing.assert_array_equal(m_t, want[0])
    np.testing.assert_array_equal(m_d, want[1])
    np.testing.assert_array_equal(off, want[2])


def seam_case(name):
    """(batch, gi int64, gj int64, flat, starts, seed scores, KEY_BITS) of
    an input aimed at a seam of the stream kernels:

    long_run       one (row, code, sequence) hit 10,000 times at random
                   positions of a one-letter target (a run across many
                   4,096-hit blocks of the run kernels, and across their
                   threads), among random hits;
    long_run_wide  the same with keys too wide to pack (two sorts);
    all_halves     one query per base-21 code h whose two halves are h
                   and 9,260 - h: every one of the 9,261 query halves;
    one_half       hits on one row of a one-letter query: one half;
    heavy_ties     rows over two letters and a seed matrix of two values,
                   -127 and 127 (scores tie heavily, at the range's ends);
    single_hit     one hit;
    all_dropped    hits on pad rows and past the target only."""
    rng = np.random.default_rng(23)
    key_bits = 0 if name == "long_run_wide" else pd.KEY_BITS
    scores = load_matrix(PrefilterParams().seed_matrix, 8.0).scores
    if name in ("long_run", "long_run_wide"):
        batch, gi, gj, flat, starts, _ = stream_case(5, n_hits=2000)
        run_seq = np.full(5000, 3, dtype=np.uint8)
        pos = starts[-1] + rng.integers(0, len(run_seq) - batch.span, 10000)
        flat = np.concatenate([flat, run_seq])
        starts = np.append(starts, len(flat))
        gi = np.concatenate([gi, np.full(len(pos), gi[0])])
        gj = np.concatenate([gj, pos])
        perm = rng.permutation(len(gi))
        return batch, gi[perm], gj[perm], flat, starts, scores, key_bits
    if name == "all_halves":
        params = PrefilterParams()
        offs = np.asarray(params.offsets)
        q_all = []
        for h in range(pd.N_QUERY_HALVES):
            q = rng.integers(0, 21, params.pattern_span + 1)
            for code, at in ((h, offs[:3]), (pd.N_QUERY_HALVES - 1 - h,
                                              offs[3:])):
                q[at] = (code // 441, code // 21 % 21, code % 21)
            q_all.append(q.astype(np.int64))
        batch = pd.build_query_batch(q_all, list(range(len(q_all))),
                                     [np.zeros(len(q)) for q in q_all],
                                     params)
        _, _, _, flat, starts, _ = stream_case(5, n_hits=0)
        gi = batch.q_starts[:-1]
        gj = rng.integers(0, len(flat) - batch.span, len(gi))
        return batch, gi, gj, flat, starts, scores, key_bits
    kw = {"one_half": dict(n_queries=1, alphabet=1),
          "heavy_ties": dict(alphabet=2, n_queries=20),
          "single_hit": dict(n_hits=1),
          "all_dropped": dict(n_hits=0, pad_hits=200)}[name]
    batch, gi, gj, flat, starts, _ = stream_case(9, **kw)
    if name == "one_half":
        gi = np.zeros_like(gi)
    if name == "heavy_ties":
        scores = rng.choice(np.array([-127, 127], dtype=np.int32), (21, 21))
    if name == "single_hit":
        gi, gj = gi[:1], gj[:1]
    return batch, gi, gj, flat, starts, scores, key_bits


SEAM_CASES = ["long_run", "long_run_wide", "all_halves", "one_half",
              "heavy_ties", "single_hit", "all_dropped"]


# ------------------------------------------------------------ the rebuild

@pytest.mark.parametrize("seed", range(5))
def test_plain_rebuild_matches_jax(seed):
    batch, gi, gj, flat, starts, seed_m = stream_case(seed)
    got = plain_rebuild(batch, gi, gj, flat, starts, seed_m.scores)
    assert_same_streams(got, jax_streams(batch, gi, gj, flat, starts,
                                         seed_m.scores))
    assert len(got[0]) > 1000


@pytest.mark.parametrize("case", ["empty_keys", "single_key", "no_hits",
                                  "repeated_halves", "rank_chunks",
                                  "wide_keys", "pad_hits"])
def test_plain_rebuild_edges(case, monkeypatch):
    """Keys without hits, one key, no hit at all, rows over two letters
    (their halves repeat), rank tables sorted 7 at a time, keys wider
    than the bit budget (two stable sorts), and hits on pad rows and past
    the target (dropped)."""
    kw = {"empty_keys": dict(hit_keys=[1, 4, 5, 9]),
          "single_key": dict(n_queries=1),
          "no_hits": dict(n_hits=0),
          "repeated_halves": dict(alphabet=2, n_queries=20),
          "rank_chunks": dict(n_queries=40),
          "wide_keys": dict(n_queries=30),
          "pad_hits": dict(pad_hits=200)}[case]
    if case == "rank_chunks":
        monkeypatch.setattr(pd, "RANK_CHUNK", 7)
    if case == "wide_keys":
        monkeypatch.setattr(pd, "KEY_BITS", 0)
    batch, gi, gj, flat, starts, seed_m = stream_case(11, **kw)
    assert pd.stream_inputs(batch, flat, starts, seed_m.scores,
                            "cpu")[-1] == (case != "wide_keys")
    got = plain_rebuild(batch, gi, gj, flat, starts, seed_m.scores)
    assert_same_streams(got, jax_streams(batch, gi, gj, flat, starts,
                                         seed_m.scores))
    if case == "empty_keys":
        assert list(np.flatnonzero(np.diff(got[2]))) == [1, 4, 5, 9]
    if case == "no_hits":
        assert len(got[0]) == 0 and not got[2].any()


@pytest.mark.parametrize("case", SEAM_CASES)
def test_plain_rebuild_seams_match_jax(case, monkeypatch):
    """The plain rebuild of each seam case against the JAX package's
    hits_to_streams, and what the case is built to hold: the long run is
    one entry at its least position, all or one query half present, one
    entry, none."""
    batch, gi, gj, flat, starts, scores, key_bits = seam_case(case)
    monkeypatch.setattr(pd, "KEY_BITS", key_bits)
    q_flat, offsets, _, _, seed, _, _, narrow = pd.stream_inputs(
        batch, flat, starts, scores, "cpu")
    assert narrow == (case != "long_run_wide")
    got = plain_rebuild(batch, gi, gj, flat, starts, scores)
    assert_same_streams(got, jax_streams(batch, gi, gj, flat, starts,
                                         scores))
    _, tables = pd.stream_rank_tables_plain(
        q_flat, offsets, torch.from_numpy(gi.astype(np.int32)), batch.n_rows,
        seed)
    m_t, m_d, off = got
    if case.startswith("long_run"):
        run_seq = len(starts) - 2
        on_run = gj >= starts[run_seq]
        assert on_run.sum() == 10000 and (m_t == run_seq).sum() == 1
        row = int(gi[on_run][0])
        ki = int(np.searchsorted(batch.q_starts, row, side="right")) - 1
        least = int(gj[on_run].min() - starts[run_seq])
        assert m_d[m_t == run_seq][0] == (row - batch.q_starts[ki]
                                          - least) & 0xFFFF
    if case in ("all_halves", "one_half"):
        assert tables.shape[0] == (pd.N_QUERY_HALVES if case == "all_halves"
                                   else 1)
    if case in ("single_hit", "all_dropped"):
        assert len(m_t) == (case == "single_hit") and off[-1] == len(m_t)


@pytest.mark.parametrize("case", ["all_halves", "heavy_ties"])
def test_plain_rank_tables_seams_match_half_rank(case):
    """Every query half's plain rank table against the JAX package's
    SimilarKmerEnumerator.half_rank: all 9,261 halves, and halves under a
    seed matrix whose scores tie heavily."""
    from spacepharer_tpu.ops.prefilter import SimilarKmerEnumerator
    batch, gi, _, flat, starts, scores, _ = seam_case(case)
    q_flat, offsets, _, _, seed, _, _, _ = pd.stream_inputs(
        batch, flat, starts, scores, "cpu")
    slot_of, tables = pd.stream_rank_tables_plain(
        q_flat, offsets, torch.from_numpy(gi.astype(np.int32)), batch.n_rows,
        seed)
    uniq = np.flatnonzero(slot_of.numpy() >= 0)
    if case == "all_halves":
        assert len(uniq) == pd.N_QUERY_HALVES
    enum = SimilarKmerEnumerator(scores)
    for code in uniq:
        tri = np.array([code // 441, code // 21 % 21, code % 21])
        np.testing.assert_array_equal(tables[slot_of[code]].numpy(),
                                      enum.half_rank(tri))


@pytest.mark.parametrize("narrow", [True, False])
def test_sort_keys_returns_the_sorted_keys(narrow, monkeypatch):
    """sort_keys' second output is the keys in its order, key[perm], and
    that order sorts (key, tseq), dropped hits first: packed keys and
    keys sorted in two passes."""
    if not narrow:
        monkeypatch.setattr(pd, "KEY_BITS", 0)
    batch, gi, gj, flat, starts, seed_m = stream_case(2, pad_hits=100)
    q_flat, offsets, t, ts, seed, _, seq_bits, is_narrow = pd.stream_inputs(
        batch, flat, starts, seed_m.scores, "cpu")
    assert is_narrow == narrow
    gi_t = torch.from_numpy(gi.astype(np.int32))
    slot_of, tables = pd.stream_rank_tables(q_flat, offsets, gi_t,
                                            batch.n_rows, seed)
    key, tseq, _, _ = pd.stream_keys(
        gi_t, torch.from_numpy(gj.astype(np.int64)), q_flat, offsets,
        batch.n_rows, t, ts, slot_of, tables, seq_bits, narrow)
    perm, sorted_key = pd.sort_keys(key, tseq, narrow)
    assert torch.equal(sorted_key, key[perm])
    pairs = list(zip(sorted_key.tolist(), tseq[perm].tolist()))
    assert pairs == sorted(pairs) and pairs[0][0] == -1


def test_rebuild_refuses_unrankable_hits():
    """A hit whose k-mer holds an X or runs past the target has no rank
    (the dense pass never emits one): the rebuild raises."""
    batch, gi, gj, flat, starts, seed_m = stream_case(3, n_hits=50)
    for bad_j in (len(flat) - 1, int(gj[0])):
        f = flat.copy()
        f[int(gj[0]) + int(batch.offsets[2])] = pd.X_IDX
        g = gj.copy()
        g[0] = bad_j
        with pytest.raises(RuntimeError, match="holds an X or runs past"):
            plain_rebuild(batch, gi, g, f, starts, seed_m.scores)


@pytest.mark.parametrize("seed,alphabet", [(0, 20), (1, 3), (2, 21)])
def test_plain_rank_tables_match_half_rank(seed, alphabet):
    """Every query half of the hit rows (X halves of the batch's tail
    included) is numbered in ascending code, and its table equals the JAX
    package's SimilarKmerEnumerator.half_rank entry for entry."""
    from spacepharer_tpu.ops.prefilter import SimilarKmerEnumerator
    batch, gi, _, flat, starts, seed_m = stream_case(seed, alphabet=alphabet)
    q_flat, offsets, _, _, seed, _, _, _ = pd.stream_inputs(
        batch, flat, starts, seed_m.scores, "cpu")
    gi_t = torch.from_numpy(gi.astype(np.int32))
    slot_of, tables = pd.stream_rank_tables(q_flat, offsets, gi_t,
                                            batch.n_rows, seed)
    halves = torch.cat(pd.query_halves(q_flat, offsets, gi_t.long()))
    uniq = np.unique(halves.numpy())
    np.testing.assert_array_equal(np.flatnonzero(slot_of.numpy() >= 0), uniq)
    np.testing.assert_array_equal(slot_of.numpy()[uniq], np.arange(len(uniq)))
    assert tables.dtype == torch.int16 and tables.shape == (len(uniq),
                                                           pd.N_HALF)
    enum = SimilarKmerEnumerator(seed_m.scores)
    for code in uniq:
        tri = np.array([code // 441, code // 21 % 21, code % 21])
        np.testing.assert_array_equal(tables[slot_of[code]].numpy(),
                                      enum.half_rank(tri))
    assert any(pd.X_IDX in (c // 441, c // 21 % 21, c % 21) for c in uniq)


def test_build_query_batch_edges():
    """The one-pass batch against the JAX package's per-key loop: ORFs
    shorter than the pattern, X letters at and off the offsets, an empty
    ORF, and no key at all."""
    from spacepharer_tpu.ops import prefilter_dense as jpd
    rng = np.random.default_rng(4)
    params = PrefilterParams()
    q_all = [rng.integers(0, 21, n).astype(np.int64)
             for n in (3, 7, 8, 9, 0, 40, 12, 60)]
    bias = [rng.normal(0, 3, len(q)) for q in q_all]
    for keys in (list(range(len(q_all))), [5, 1, 7], [4], []):
        got = pd.build_query_batch(q_all, keys, bias, params)
        want = jpd.build_query_batch(q_all, keys, bias, params)
        for f in ("q_flat", "q_starts", "kmer_thr", "kmer_valid"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert (got.n_rows, got.keys) == (want.n_rows, want.keys)


@pytest.mark.parametrize("seed", [0, 5])
def test_qexp_i8_is_build_qexp(seed):
    """The int8 Qexp the kernels read, built directly, equals the JAX
    package's build_qexp (float32, the numpy oracle's) cast to int8, pad
    rows zero, and its thresholds the batch's."""
    from spacepharer_tpu.ops import prefilter_dense as jpd
    params, seed_m, q_all, bias80, batch, _, _, _ = _case(seed)
    qexp, thr = pd.build_qexp_i8(batch, seed_m.scores)
    jb = jpd.build_query_batch(q_all, list(range(len(q_all))), bias80,
                               params)
    assert qexp.dtype == np.int8 and qexp.shape[0] % pd.TILE_Q == 0
    np.testing.assert_array_equal(
        qexp, jpd.build_qexp(jb, seed_m.scores, qexp.shape[0]).astype(
            np.int8))
    np.testing.assert_array_equal(thr[:batch.n_rows], jb.kmer_thr)
    assert (thr[batch.n_rows:] == pd.THR_INVALID).all()


# ----------------------------------------------------------- the finalize

def _shim(flat, starts, params):
    n = len(starts) - 1
    return TargetIndex(
        seqs_masked=[flat[starts[i]:starts[i + 1]] for i in range(n)],
        seq_lengths=np.diff(starts),
        post_seq=np.zeros(0, np.int32), post_pos=np.zeros(0, np.uint16),
        uniq_codes=np.zeros(0, np.int64), uniq_start=np.zeros(1, np.int64),
        uniq_letters=np.zeros((0, params.kmer_size), np.int8),
        db_residues=int(starts[-1]), flat_masked=flat, masked_starts=starts)


def _dense_streams(seed, mask):
    params, seed_m, q_all, bias80, batch, flat, starts, bval = _case(seed,
                                                                     mask)
    gi, gj = pd.match_pairs(batch, flat, bval, seed_m.scores,
                            params.kmer_threshold(), device="cpu")
    streams = pd.rebuild_streams(batch, gi, gj, flat, starts, seed_m.scores)
    return params, q_all, bias80, flat, starts, streams


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_finalize_matches_per_key_native(seed, mask):
    """The one native call over every key against the per-key native
    finalize of the same streams, and the plain per-key version (the CPU
    route without the native library) against both."""
    from spacepharer_tpu_torch.native import get_lib
    params, q_all, bias80, flat, starts, (m_t, m_d, off) = _dense_streams(
        seed, mask)
    ungapped_m = load_matrix(params.ungapped_matrix, 2.0)
    keys = list(range(len(q_all)))
    q8, qs = pd.flat_keys(q_all, keys, np.uint8)
    args = (m_t, m_d, off, q8, qs, pd.flat_keys(bias80, keys, np.float64)[0],
            flat, starts, params, ungapped_m)
    t, s, d, hoff = pd.finalize_streams(*args)
    plain = pd.finalize_streams_plain(*args)
    shim = _shim(flat, starts, params)
    n = 0
    for i in keys:
        got = list(zip(*(a[hoff[i]:hoff[i + 1]].tolist() for a in (t, s, d))))
        q = np.asarray(q_all[i], dtype=np.int64)
        profile, cap = ungapped_profile_cap(q, bias80[i], ungapped_m)
        want = [] if off[i] == off[i + 1] else [
            (h.target, h.score, h.diagonal) for h in _finalize_native(
                get_lib(), m_t[off[i]:off[i + 1]], m_d[off[i]:off[i + 1]],
                shim, profile, cap, params, q)]
        assert got == want, i
        assert got == list(zip(*(a[plain[3][i]:plain[3][i + 1]].tolist()
                                 for a in plain[:3]))), i
        n += len(got)
    assert n > 0


@pytest.mark.parametrize("bias", ["given", "native"])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_route_arrays_match_jax_device_prefilter(seed, mask, bias):
    """device_prefilter_arrays on the CPU (plain dense pass and rebuild,
    the batch finalize) against the JAX package's device_prefilter
    (numpy backend): each key's (target, score, diagonal) in order, with
    the composition bias given per key or computed by the route in one
    native call (as search_setdbs asks)."""
    from spacepharer_tpu.ops import prefilter_dense as jpd
    from spacepharer_tpu.ops.prefilter import SimilarKmerEnumerator
    params, seed_m, q_all, bias80, _, flat, starts, _ = _case(seed, mask)
    ungapped_m = load_matrix(params.ungapped_matrix, 2.0)
    keys = list(range(len(q_all)))
    t, s, d, off = pd.device_prefilter_arrays(
        q_all, keys, bias80 if bias == "given" else None, flat, starts,
        params, seed_m, ungapped_m, device="cpu")
    assert t.dtype == s.dtype == d.dtype == np.int32 and off.dtype == np.int64
    want = jpd.device_prefilter(q_all, keys, bias80, flat, starts, params,
                                SimilarKmerEnumerator(seed_m.scores), seed_m,
                                ungapped_m, backend="numpy")
    for i, k in enumerate(keys):
        assert list(zip(t[off[i]:off[i + 1]].tolist(),
                        s[off[i]:off[i + 1]].tolist(),
                        d[off[i]:off[i + 1]].tolist())) == [
            (h.target, h.score, h.diagonal) for h in want[k]], k
    assert off[-1] > 0


@pytest.mark.parametrize("native", [True, False])
def test_composition_bias_matches_local_aa_bias(native, monkeypatch):
    """The route's flat composition bias (one native call, or
    local_aa_bias_batch without the library) equals the JAX package's
    local_aa_bias per query bit for bit: spacer-length, window-edge,
    long, X-rich and empty queries, under VTML80 and BLOSUM62; zeros
    with the correction off."""
    from spacepharer_tpu.ops.bias import local_aa_bias
    from spacepharer_tpu.ops.matrices import load_matrix as jax_load_matrix
    from spacepharer_tpu_torch import native as native_mod
    if not native:
        monkeypatch.setattr(native_mod, "get_lib", lambda: None)
    rng = np.random.default_rng(8)
    q_all = [rng.integers(0, 21, n).astype(np.uint8)
             for n in (9, 12, 1, 0, 39, 40, 41, 300, 15)]
    q_all.append(np.full(25, 20, dtype=np.uint8))
    keys = [3, 0, 7, 1, 9, 2, 4, 5, 6, 8]
    q8, qs = pd.flat_keys(q_all, keys, np.uint8)
    for name in ("VTML80.out", "blosum62.out"):
        got = pd.composition_bias(q8, qs, load_matrix(name, 8.0), True)
        jm = jax_load_matrix(name, 8.0)
        want = np.concatenate([local_aa_bias(q_all[k].astype(np.int64), jm)
                               for k in keys])
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got.view(np.int64),
                                      want.view(np.int64))
    assert not pd.composition_bias(q8, qs, load_matrix("VTML80.out", 8.0),
                                   False).any()


def test_route_on_a_card_needs_the_native_library(monkeypatch):
    """No per-key fallback on the card's route: without the native
    library the dense prefilter asked for on a card raises before any
    work."""
    from spacepharer_tpu_torch import native
    params, seed_m, q_all, bias80, _, flat, starts, _ = _case(0)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    with pytest.raises(RuntimeError, match="native library"):
        pd.device_prefilter_arrays(
            q_all, list(range(len(q_all))), bias80, flat, starts, params,
            seed_m, load_matrix(params.ungapped_matrix, 2.0), device="cuda")


def test_golden_cli_dense_route_hands_arrays_on(golden, tmp_path,
                                                monkeypatch):
    """The golden bundle through `predictmatch --prefilter-engine device
    --use-tpu 0` on the CPU: run/result.tsv byte for byte, the search
    through one stream rebuild and one batch finalize (its control search
    forks onto the host engine), and never through the dict form (no
    PrefilterHit on the route)."""
    from spacepharer_tpu_torch import cli
    from test_torch_predictmatch import _golden_paths
    calls = []

    def counted(name):
        fn = getattr(pd, name)

        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped

    for name in ("rebuild_streams", "finalize_streams"):
        monkeypatch.setattr(pd, name, counted(name))
    monkeypatch.setattr(pd, "device_prefilter", None)
    monkeypatch.setenv(pm.DEVICE_ENV, "cpu")
    out = tmp_path / "result.tsv"
    rc = cli.main(["predictmatch", *_golden_paths(golden), str(out),
                   str(tmp_path / "tmp"), "--prefilter-engine", "device",
                   "--use-tpu", "0", "-v", "1"])
    assert rc == 0
    with open(os.path.join(golden, "result.tsv")) as fh:
        assert out.read_text() == fh.read()
    assert calls == ["rebuild_streams", "finalize_streams"]


# --------------------------------------------------- the kernels on a card

def card_streams_check(batch, gi, gj, flat, starts, scores):
    """Each stream kernel against its plain version on the same card
    tensors (the rank tables, the keys, the runs of one sorted order),
    and the whole rebuild on the card against the plain rebuild on the
    CPU. Returns the largest difference (0) and the launches made."""
    names = ("prefilter_streams_ranks_launches",
             "prefilter_streams_keys_launches",
             "prefilter_streams_runs_launches")
    before = _counted(*names)
    q_flat, offsets, t, ts, seed, qs, seq_bits, narrow = pd.stream_inputs(
        batch, flat, starts, scores, "cuda")
    slot_of, tables = pd.stream_rank_tables(q_flat, offsets, gi,
                                            batch.n_rows, seed)
    p_slot, p_tables = pd.stream_rank_tables_plain(q_flat, offsets, gi,
                                                   batch.n_rows, seed)
    err = int((slot_of != p_slot).sum()) + int((tables != p_tables).sum())
    keys = pd.stream_keys(gi, gj, q_flat, offsets, batch.n_rows, t, ts,
                          slot_of, tables, seq_bits, narrow)
    plain = pd.stream_keys_plain(gi, gj, q_flat, offsets, batch.n_rows, t,
                                 ts, slot_of, tables, seq_bits, narrow)
    err += sum(int((a != b).sum()) for a, b in zip(keys, plain))
    perm, sorted_key = pd.sort_keys(keys[0], keys[1], narrow)
    runs = pd.stream_runs(perm, *keys[:3], gi, qs, len(batch.keys),
                          sorted_key, seq_bits, narrow)
    p_runs = pd.stream_runs_plain(perm, *keys[:3], gi, qs, len(batch.keys))
    n = int(p_runs[3])
    err += int(runs[3] != p_runs[3]) + int((runs[2] != p_runs[2]).sum())
    err += sum(int((a[:n].long() != b.long()).sum())
               for a, b in zip(runs[:2], p_runs[:2]))
    whole = pd.rebuild_streams(batch, gi, gj, flat, starts, scores)
    want = pd.rebuild_streams(batch, gi.cpu(), gj.cpu(), flat, starts, scores)
    err += sum(int((a.astype(np.int64) != b.astype(np.int64)).sum())
               for a, b in zip(whole, want))
    torch.cuda.synchronize()
    launched = tuple(a - b for a, b in zip(_counted(*names), before))
    return err, launched


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "wide_keys", "pad_hits",
                                  "no_hits", "repeated_halves"])
def test_cuda_stream_kernels_match_plain_random(case, monkeypatch):
    """The stream kernels against their plain versions on random hits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    kw = {"random": {}, "wide_keys": dict(n_queries=30),
          "pad_hits": dict(pad_hits=300), "no_hits": dict(n_hits=0),
          "repeated_halves": dict(alphabet=2, n_queries=20)}[case]
    if case == "wide_keys":
        monkeypatch.setattr(pd, "KEY_BITS", 0)
    batch, gi, gj, flat, starts, seed_m = stream_case(7, **kw)
    err, launched = card_streams_check(
        batch, torch.from_numpy(gi.astype(np.int32)).cuda(),
        torch.from_numpy(gj.astype(np.int64)).cuda(), flat, starts,
        seed_m.scores)
    assert err == 0
    assert launched == (2, 2, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SEAM_CASES)
def test_cuda_stream_kernels_match_plain_seams(case, monkeypatch):
    """The stream kernels against their plain versions on the inputs
    aimed at the redesigned kernels' seams (seam_case)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    batch, gi, gj, flat, starts, scores, key_bits = seam_case(case)
    monkeypatch.setattr(pd, "KEY_BITS", key_bits)
    err, launched = card_streams_check(
        batch, torch.from_numpy(gi.astype(np.int32)).cuda(),
        torch.from_numpy(gj.astype(np.int64)).cuda(), flat, starts, scores)
    assert err == 0
    assert launched == (2, 2, 2)


def card_case(name):
    """(params, seed scores, batch, masked flat, starts, boundary
    validity) of a CUDA_CASES entry: cuda_case's, with the target's
    starts."""
    if name in EDGE_CASES:
        params, scores, batch, targets = EDGE_CASES[name]()
        flat, starts = build_masked_flat(targets, PrefilterParams(mask=False))
        return (params, scores, batch, flat, starts,
                pd.target_boundary_valid(starts, batch.span))
    if name == "zero_hits":
        params, seed_m, batch, flat, bval = cuda_case(name)
        return (params, seed_m.scores, batch, flat,
                np.array([0, 400, len(flat)], dtype=np.int64), bval)
    params, seed_m, _, _, batch, flat, starts, bval = _case(
        *CUDA_CASES[name][:2], **CUDA_CASES[name][2])
    return params, seed_m.scores, batch, flat, starts, bval


# the match streams take two halves of 3 offsets
SIX_OFFSET_CASES = [c for c in CUDA_CASES if c != "four_offsets"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SIX_OFFSET_CASES)
def test_cuda_stream_kernels_match_plain(case):
    """The stream kernels against their plain versions on the dense
    pass's own hits (match_pairs on the card) of every `cuda` case with
    six offsets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    params, scores, batch, flat, starts, bval = card_case(case)
    gi, gj = pd.match_pairs(batch, flat, bval, scores,
                            params.kmer_threshold(), device="cuda")
    err, launched = card_streams_check(batch, gi, gj, flat, starts, scores)
    assert err == 0
    assert launched == (2, 2, 2)


@pytest.mark.parametrize("case", SIX_OFFSET_CASES)
def test_card_cases_rebuild_matches_jax(case):
    """The plain rebuild of each `cuda` case's dense hits (plain pass on
    the CPU) against the JAX package's hits_to_streams."""
    params, scores, batch, flat, starts, bval = card_case(case)
    gi, gj = pd.match_pairs(batch, flat, bval, scores,
                            params.kmer_threshold(), device="cpu")
    assert_same_streams(
        pd.rebuild_streams(batch, gi, gj, flat, starts, scores),
        jax_streams(batch, gi.numpy().astype(np.int64), gj.numpy(), flat,
                    starts, scores))
