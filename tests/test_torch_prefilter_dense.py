"""The port's dense prefilter (ops/prefilter_dense.py) against the JAX
package's, on the corpora of tests/test_prefilter_dense.py.

Every quantity is an integer, so every comparison is exact. The CPU
cases run the kernels' plain PyTorch versions and hold them against the
JAX package: its host helpers, its Pallas counts kernel in interpret
mode, its numpy oracle and its device_prefilter. The `cuda` cases hold
the CUDA kernels against the plain versions on the card. JAX is imported
only where the JAX side runs, so the `cuda` cases also run where JAX is
not installed (`pytest -m cuda tests/test_torch_prefilter_dense.py` on a
GPU box).
"""
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from spacepharer_tpu_torch.logging import timings
from spacepharer_tpu_torch.ops import prefilter_dense as pd
from spacepharer_tpu_torch.ops.bias import local_aa_bias
from spacepharer_tpu_torch.ops.matrices import load_matrix
from spacepharer_tpu_torch.ops.prefilter import (
    PrefilterParams, SimilarKmerEnumerator, build_masked_flat)


# the registry counters of the kernel's launches and of the chunks that
# ran again into a larger buffer
LAUNCHES = ("prefilter_dense_hits_launches", "dense_hit_reruns")


def _counted(*names):
    """The registry's totals (logging.timings) of the named counters."""
    got = timings()
    return tuple(got.get(n, 0) for n in names)


def make_corpus(seed, n_targets=40, n_queries=12):
    """tests/test_prefilter_dense.py::make_corpus: random targets with 5 %
    X, short queries, each planted 3 times into the targets."""
    rng = np.random.default_rng(seed)
    targets = []
    for _ in range(n_targets):
        L = int(rng.integers(5, 120))
        s = rng.integers(0, 20, size=L).astype(np.uint8)
        s[rng.random(L) < 0.05] = 20
        targets.append(s)
    queries = [rng.integers(0, 20, size=int(rng.integers(9, 14))).astype(
        np.uint8) for _ in range(n_queries)]
    for q in queries:
        for _ in range(3):
            t = targets[int(rng.integers(0, n_targets))]
            if len(t) <= len(q):
                continue
            pos = int(rng.integers(0, len(t) - len(q)))
            t[pos:pos + len(q)] = q
    return queries, targets


def _case(seed, mask=False, **kw):
    """(params, seed matrix, q_all, bias80, batch, masked flat, starts,
    boundary validity) of a corpus, built by the port."""
    queries, targets = make_corpus(seed, **kw)
    params = PrefilterParams(mask=mask)
    seed_m = load_matrix(params.seed_matrix, 8.0)
    q_all = [np.asarray(q, np.int64) for q in queries]
    bias80 = [local_aa_bias(q, seed_m) for q in q_all]
    batch = pd.build_query_batch(q_all, list(range(len(q_all))), bias80,
                                 params)
    flat, starts = build_masked_flat(targets, params)
    bval = pd.target_boundary_valid(starts, batch.span)
    return params, seed_m, q_all, bias80, batch, flat, starts, bval


def pairs(gi, gj):
    """Sorted (gi, gj) pairs of hits given as arrays or tensors (on any
    device)."""
    def values(x):
        return torch.as_tensor(x).cpu().tolist()

    return sorted(zip(values(gi), values(gj)))


def plain_pass(inputs, capacity):
    """(gi, gj, n) of the plain pass over the compacted rows of `inputs`
    (dense_inputs' form) into a new buffer of `capacity` hits: the buffer's
    arrays and the cursor's count."""
    gi, gj, cursor = pd.new_hit_buffer(capacity, inputs[0].device)
    pd.prefilter_dense_hits_plain(pd.compact_rows(inputs[0], inputs[1]),
                                  *inputs[2:], gi, gj, cursor)
    return gi, gj, int(cursor.item())


def tile_counts(gi, gj, inputs):
    """int64 [ntt, nqt]: the hits per (target tile, query tile) of the
    grid of `inputs`, the TPU counts kernel's output."""
    nqt = inputs[0].shape[0] // pd.TILE_Q
    ntt = inputs[3].numel() // pd.TILE_T
    flat = (torch.as_tensor(gj).long() // pd.TILE_T) * nqt \
        + torch.as_tensor(gi).long() // pd.TILE_Q
    return torch.bincount(flat, minlength=ntt * nqt).reshape(ntt, nqt)


@dataclass
class _EdgeParams:
    """What the dense pass reads of PrefilterParams, with any offsets."""
    offsets: np.ndarray
    pattern_span: int
    kmer_thr: int

    def kmer_threshold(self):
        return self.kmer_thr


def _plant(rng, pieces, n_random, length=(20, 80)):
    """Target ORFs: each piece with random flanks, then random ORFs."""
    ts = [np.concatenate([rng.integers(0, 20, int(rng.integers(0, 9))),
                          np.asarray(p), rng.integers(0, 20, 5)])
          for p in pieces]
    ts += [rng.integers(0, 20, int(rng.integers(*length)))
           for _ in range(n_random)]
    return [t.astype(np.uint8) for t in ts]


def _self_scores(batch, scores):
    """int64 [n_rows]: each k-mer row's K against its own k-mer."""
    d = np.diag(scores).astype(np.int64)
    return sum(d[batch.q_flat[o:o + batch.n_rows]] for o in batch.offsets)


def _edge_thr762():
    """A matrix with 127 on the diagonal: rows at thr = 762 whose k-mer is
    planted exactly (K = 762: a hit) or with one mismatch (no hit), a row
    at 761, and the other valid rows at 700 (only exact k-mers hit)."""
    rng = np.random.default_rng(31)
    S = rng.integers(-40, 41, (21, 21))
    np.fill_diagonal(S, 127)
    S[20, :] = S[:, 20] = -1
    params = _EdgeParams(np.array([0, 1, 3, 4, 5, 7]), 8, 100)
    q_all = [rng.integers(0, 20, 12) for _ in range(4)]
    one_off = q_all[1][:8].copy()
    one_off[0] = (one_off[0] + 1) % 20
    targets = _plant(rng, [q_all[0], one_off, q_all[2][:8], q_all[3]], 6)
    batch = pd.build_query_batch(q_all, list(range(4)),
                                 [np.zeros(12)] * 4, params)
    valid = batch.kmer_thr <= pd.MAX_K
    batch.kmer_thr[valid] = 700
    s0 = batch.q_starts
    batch.kmer_thr[[s0[0], s0[1]]] = 762
    batch.kmer_thr[s0[2]] = 761
    return params, S, batch, targets


def _edge_thr0():
    """Rows at thr = 0: every valid position with K >= 0 hits."""
    rng = np.random.default_rng(32)
    params = PrefilterParams(mask=False)
    S = load_matrix(params.seed_matrix, 8.0).scores
    q_all = [rng.integers(0, 20, int(n)) for n in (10, 13, 9)]
    batch = pd.build_query_batch(q_all, [0, 1, 2],
                                 [np.zeros(len(q)) for q in q_all], params)
    batch.kmer_thr[batch.kmer_thr <= pd.MAX_K] = 0
    return params, S, batch, _plant(rng, [], 12)


def _edge_tile_fill():
    """Query tiles with 0, 1, 15, 16, 17 and 256 rows that can match (one
    1,543-letter query: six tiles of 256 rows, and a seventh of its last
    7 rows, which cannot match); each such row at its own K less 20, and
    its k-mer planted once."""
    rng = np.random.default_rng(33)
    params = PrefilterParams(mask=False)
    S = load_matrix(params.seed_matrix, 8.0).scores
    q = rng.integers(0, 20, 6 * pd.TILE_Q + 7)
    batch = pd.build_query_batch([q], [0], [np.zeros(len(q))], params)
    own = _self_scores(batch, S)
    batch.kmer_thr[:] = pd.THR_INVALID
    pieces = []
    for tile, n in enumerate((0, 1, 15, 16, 17, 256)):
        rows = tile * pd.TILE_Q + np.sort(rng.choice(pd.TILE_Q, n,
                                                     replace=False))
        batch.kmer_thr[rows] = np.maximum(own[rows] - 20, 0)
        if n < pd.TILE_Q:
            pieces += [q[r:r + 8] for r in rows]
    pieces.append(q[5 * pd.TILE_Q:6 * pd.TILE_Q + 7])
    return params, S, batch, _plant(rng, pieces, 4)


def _edge_four_offsets():
    """4 spaced offsets (0, 1, 3, 4): Qexp blocks 4 and 5 are zero."""
    rng = np.random.default_rng(34)
    params = _EdgeParams(np.array([0, 1, 3, 4]), 5, 75)
    S = load_matrix(PrefilterParams().seed_matrix, 8.0).scores
    q_all = [rng.integers(0, 20, int(n)) for n in (14, 11, 16, 9, 12)]
    batch = pd.build_query_batch(q_all, list(range(5)),
                                 [np.zeros(len(q)) for q in q_all], params)
    return params, S, batch, _plant(rng, q_all, 10)


def _one_query(seed, n_valid, thr_less, planted, length=None):
    """(params, S, batch, targets) of one query whose n_valid k-mer rows
    all can match (no X), each at its own K less thr_less, and one target
    ORF of `length` random residues (or just long enough) with row r's
    k-mer planted at position j for each (r, j) of `planted`. The k-mer
    threshold 0 makes every target k-mer inside the ORF valid."""
    rng = np.random.default_rng(seed)
    S = load_matrix(PrefilterParams().seed_matrix, 8.0).scores
    params = _EdgeParams(np.array([0, 1, 3, 4, 5, 7]), 8, 0)
    span = params.pattern_span
    q = rng.integers(0, 20, n_valid + span)
    batch = pd.build_query_batch([q], [0], [np.zeros(len(q))], params)
    assert int((batch.kmer_thr <= pd.MAX_K).sum()) == n_valid
    batch.kmer_thr[:n_valid] = _self_scores(batch, S)[:n_valid] - thr_less
    if length is None:
        length = max(j for _, j in planted) + span + 5
    t = rng.integers(0, 20, length).astype(np.uint8)
    for r, j in planted:
        t[j:j + span] = q[r:r + span]
    return params, S, batch, [t]


def _edge_one_stage():
    """Exactly one stage of the counts kernel: 128 rows that can match,
    no pad row, 10 of them planted."""
    rng = np.random.default_rng(35)
    rows = rng.choice(pd.ROW_TILE, 10, replace=False)
    return _one_query(35, pd.ROW_TILE, 20,
                      [(int(r), 40 * k + 3) for k, r in enumerate(rows)])


def _edge_last_cell():
    """The last row of each of three stages (127, 255, 383) hits at the
    last position of target tiles 0-2 (511, 1023, 1535), and row 0 at the
    first position of tile 4."""
    last = [pd.ROW_TILE * s - 1 for s in (1, 2, 3)]
    planted = [(r, pd.TILE_T * (k + 1) - 1) for k, r in enumerate(last)]
    return _one_query(36, 3 * pd.ROW_TILE, 20,
                      planted + [(0, 4 * pd.TILE_T)])


def _edge_k_eq_thr():
    """Rows at thr = their own K: each planted k-mer hits with K exactly
    thr, and a copy of it with one letter changed (K below thr) does not."""
    rng = np.random.default_rng(37)
    params, S, batch, _ = _one_query(37, 200, 0, [(0, 0)])
    q = batch.q_flat
    pieces = []
    for r in rng.choice(200, 12, replace=False):
        kmer = q[r:r + 8].copy()
        pieces.append(kmer.copy())
        kmer[0] = (kmer[0] + 1) % 20
        pieces.append(kmer)
    return params, S, batch, _plant(rng, pieces, 6)


def _edge_ring_wrap():
    """14 stages (1,669 rows that can match), not a multiple of the
    counts kernel's ring of 6 stages, over three target tiles."""
    rng = np.random.default_rng(38)
    rows = rng.choice(1669, 16, replace=False)
    return _one_query(38, 1669, 15,
                      [(int(r), 90 * k + 7) for k, r in enumerate(rows)],
                      length=3 * pd.TILE_T - 40)


def _edge_many_tiles():
    """137 target tiles, more than the counts kernel's persistent grid (a
    block a multiprocessor, 132 on an H100) and not a multiple of it, so
    some blocks walk two tiles, each against 5 stages; 30 rows planted
    across the tiles. Every other case has fewer tiles than the grid."""
    rng = np.random.default_rng(39)
    rows = rng.choice(600, 30, replace=False)
    return _one_query(39, 600, 15,
                      [(int(r), 2300 * k + 11) for k, r in enumerate(rows)],
                      length=137 * pd.TILE_T - 300)


def _edge_one_cell():
    """Every one of a query tile's 256 rows hits every valid position of
    one target tile (thr = -762): the most atomic adds on one count."""
    params, S, batch, targets = _one_query(40, pd.TILE_Q, 0, [(0, 0)],
                                           length=400)
    batch.kmer_thr[:pd.TILE_Q] = -pd.MAX_K
    return params, S, batch, targets


EDGE_CASES = {"thr762": _edge_thr762, "thr0": _edge_thr0,
              "tile_fill": _edge_tile_fill,
              "four_offsets": _edge_four_offsets,
              "one_stage": _edge_one_stage, "last_cell": _edge_last_cell,
              "k_eq_thr": _edge_k_eq_thr, "ring_wrap": _edge_ring_wrap,
              "many_tiles": _edge_many_tiles, "one_cell": _edge_one_cell}


def edge_case(name):
    """(params, seed matrix, batch, masked flat, boundary validity) of an
    EDGE_CASES entry, in cuda_case's form."""
    params, S, batch, targets = EDGE_CASES[name]()
    flat, starts = build_masked_flat(targets, PrefilterParams(mask=False))
    return (params, SimpleNamespace(scores=S), batch, flat,
            pd.target_boundary_valid(starts, batch.span))


def _jax_tiles(batch, scores, kmer_thr, inputs, bval):
    """The JAX package's device inputs on the inputs' tile grid: (qexp
    bf16 [R, KDIM], thr [R, 1], and _device_prep_fn's Texp and tval
    tiles, tval checked against the port's prep)."""
    import jax.numpy as jnp
    from spacepharer_tpu.ops import prefilter_dense as jpd
    qexp, _, letters, tval, offsets = inputs
    R, C = qexp.shape[0], tval.numel()
    bv = np.zeros(C, dtype=bool)
    bv[:len(bval)] = bval
    texp_tiles, tval_tiles = jpd._device_prep_fn(
        batch.span, offsets, kmer_thr)(
        jnp.asarray(letters.numpy().astype(np.int32)), jnp.asarray(bv),
        jnp.asarray(np.diag(scores)[:21].astype(np.int32)))
    np.testing.assert_array_equal(
        tval.numpy(), np.asarray(tval_tiles).reshape(-1).astype(np.uint8))
    thr_col = np.full((R, 1), float(jpd.THR_INVALID), dtype=np.float32)
    thr_col[:batch.n_rows, 0] = batch.kmer_thr
    return (jnp.asarray(jpd.build_qexp(batch, scores, R), dtype=jnp.bfloat16),
            jnp.asarray(thr_col), texp_tiles, tval_tiles)


def _pallas_counts(batch, scores, kmer_thr, inputs, bval):
    """_device_prep_fn + _counts_pallas of the JAX package in interpret
    mode on the inputs' tile grid: int32 [ntt, nqt]."""
    from spacepharer_tpu.ops import prefilter_dense as jpd
    R, C = inputs[0].shape[0], inputs[3].numel()
    return np.asarray(jpd._counts_pallas(
        *_jax_tiles(batch, scores, kmer_thr, inputs, bval),
        interpret=True)).reshape(C // pd.TILE_T, R // pd.TILE_Q)


# ------------------------------------------------------------ CPU parity

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_helpers_match_jax(seed):
    """The verbatim host code: query batch, Qexp, boundary validity, the
    numpy oracle and the stream reconstruction."""
    from spacepharer_tpu.ops import prefilter_dense as jpd
    from spacepharer_tpu.ops.prefilter import \
        SimilarKmerEnumerator as JaxEnumerator
    params, seed_m, q_all, bias80, batch, flat, starts, bval = _case(seed)
    jb = jpd.build_query_batch(q_all, list(range(len(q_all))), bias80,
                               params)
    for f in ("q_flat", "q_starts", "kmer_thr", "kmer_valid", "offsets"):
        np.testing.assert_array_equal(getattr(batch, f), getattr(jb, f))
    assert (batch.span, batch.n_rows) == (jb.span, jb.n_rows)
    np.testing.assert_array_equal(
        pd.build_qexp(batch, seed_m.scores, 300),
        jpd.build_qexp(jb, seed_m.scores, 300))
    np.testing.assert_array_equal(
        bval, jpd.target_boundary_valid(starts, jb.span))
    thr = params.kmer_threshold()
    gi, gj = pd.match_pairs_numpy(batch, flat, bval, seed_m.scores, thr,
                                  chunk=777)
    jgi, jgj = jpd.match_pairs_numpy(jb, flat, bval, seed_m.scores, thr,
                                     chunk=777)
    np.testing.assert_array_equal(gi, jgi)
    np.testing.assert_array_equal(gj, jgj)
    assert len(gi) > 0
    got = pd.hits_to_streams(batch, gi, gj, flat, starts,
                             SimilarKmerEnumerator(seed_m.scores))
    want = jpd.hits_to_streams(jb, jgi, jgj, flat, starts,
                               JaxEnumerator(seed_m.scores))
    assert got.keys() == want.keys()
    for k in got:
        for a, b in zip(got[k], want[k]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_counts_match_pallas_interpret(seed):
    """prep + the plain pass on the JAX kernel's padded tile grid, its
    hits counted per tile, against _device_prep_fn + _counts_pallas in
    interpret mode."""
    params, seed_m, _, _, batch, flat, _, bval = _case(seed)
    thr = params.kmer_threshold()
    inputs = pd.dense_inputs(batch, flat, bval, seed_m.scores, thr, "cpu")
    want = _pallas_counts(batch, seed_m.scores, thr, inputs, bval)
    gi, gj, n = plain_pass(inputs, 1 << 16)
    assert gi.dtype == gj.dtype == torch.int32
    np.testing.assert_array_equal(tile_counts(gi[:n], gj[:n], inputs).numpy(),
                                  want)
    assert want.sum() > 0


@pytest.mark.parametrize("name", list(EDGE_CASES))
def test_edge_counts_match_pallas_interpret(name):
    """The kernel's edge cases: the plain pass over the compacted rows
    (compact_rows), its hits counted per tile, equals the Pallas counts
    kernel in interpret mode; match_pairs on the CPU equals the numpy
    oracle."""
    params, seed_m, batch, flat, bval = edge_case(name)
    thr = params.kmer_threshold()
    inputs = pd.dense_inputs(batch, flat, bval, seed_m.scores, thr, "cpu")
    want = _pallas_counts(batch, seed_m.scores, thr, inputs, bval)
    gi, gj, n = plain_pass(inputs, 1 << 18)
    np.testing.assert_array_equal(tile_counts(gi[:n], gj[:n], inputs).numpy(),
                                  want)
    compacted = pd.compact_rows(inputs[0], inputs[1])
    assert want.sum() > 0
    if name == "tile_fill":
        assert (want.sum(axis=0) > 0).tolist() == ([False] + [True] * 5
                                                   + [False])
    got = pairs(*pd.match_pairs(batch, flat, bval, seed_m.scores, thr,
                                device="cpu"))
    oracle = pd.match_pairs_numpy(batch, flat, bval, seed_m.scores, thr)
    assert got == pairs(*oracle)
    if name == "thr762":
        hit_rows = set(oracle[0].tolist())
        s0 = batch.q_starts
        assert s0[0] in hit_rows and s0[2] in hit_rows
        assert s0[1] not in hit_rows
    # the counts kernel's schedule edges that the later cases stand for
    stages, ntt = compacted[0].shape[0] // pd.ROW_TILE, want.shape[0]
    if name == "one_stage":
        assert stages == 1 and int((compacted[1] <= pd.MAX_K).sum()) == 128
    if name == "last_cell":
        assert {(127, 511), (255, 1023), (383, 1535), (0, 2048)} <= set(got)
    if name == "k_eq_thr":
        K = _self_scores(batch, seed_m.scores)
        assert any(K[i] == batch.kmer_thr[i] for i, _ in got)
    if name == "ring_wrap":
        assert stages == 14
    if name == "many_tiles":
        assert ntt == 137 and stages == 5
    if name == "one_cell":
        assert want[0, 0] == pd.TILE_Q * 393 == want.sum()


def test_compact_rows_keeps_rows_that_can_match():
    """compact_rows keeps the rows at thr <= 762 in order, with their row
    ids, and pads to whole row tiles with rows that never hit."""
    qexp = torch.arange(5 * pd.TILE_Q * pd.KDIM).reshape(-1, pd.KDIM)
    qexp = (qexp % 251 - 125).to(torch.int8)
    thr = torch.full((5 * pd.TILE_Q,), pd.THR_INVALID, dtype=torch.int32)
    rows = torch.tensor([0, 3, 255, 256, 700, 1279])
    thr[rows] = torch.tensor([0, 762, 5, 1, 300, 7], dtype=torch.int32)
    thr[9] = 763
    qexp_c, thr_c, row_id = pd.compact_rows(qexp, thr)
    assert qexp_c.shape == (pd.ROW_TILE, pd.KDIM)
    assert torch.equal(qexp_c[:6], qexp[rows])
    assert torch.equal(qexp_c[6:], torch.zeros_like(qexp_c[6:]))
    assert thr_c[:6].tolist() == [0, 762, 5, 1, 300, 7]
    assert bool((thr_c[6:] == pd.THR_INVALID).all())
    assert row_id.dtype == torch.int32
    assert row_id[:6].tolist() == rows.tolist()
    assert bool((row_id[6:] == 0).all())
    empty = pd.compact_rows(qexp, torch.full_like(thr, pd.THR_INVALID))
    assert empty[0].shape[0] == pd.ROW_TILE
    assert bool((empty[1] == pd.THR_INVALID).all())
    assert empty[2].tolist() == [0] * pd.ROW_TILE


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_match_pairs_matches_jax(seed):
    """The port's match_pairs on the CPU (the plain pass) against the
    numpy oracle and the JAX Pallas path in interpret mode."""
    from spacepharer_tpu.ops import prefilter_dense as jpd
    params, seed_m, _, _, batch, flat, _, bval = _case(seed)
    thr = params.kmer_threshold()
    got = pairs(*pd.match_pairs(batch, flat, bval, seed_m.scores, thr,
                                device="cpu"))
    assert got == pairs(*jpd.match_pairs_numpy(batch, flat, bval,
                                               seed_m.scores, thr))
    assert got == pairs(*jpd.match_pairs_device(
        batch, flat, bval, seed_m.scores, thr, backend="pallas",
        interpret=True, chunk=1024, extract_b=8))
    assert len(got) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mask", [False, True])
def test_device_prefilter_matches_jax(seed, mask):
    """Final hits (target, score, diagonal) of the port's device_prefilter
    on the CPU against the JAX package's (numpy backend)."""
    from spacepharer_tpu.ops import prefilter_dense as jpd
    from spacepharer_tpu.ops.prefilter import \
        SimilarKmerEnumerator as JaxEnumerator
    from spacepharer_tpu.ops.prefilter import \
        build_masked_flat as jax_build_masked_flat
    params, seed_m, q_all, bias80, _, flat, starts, _ = _case(seed, mask)
    ungapped_m = load_matrix(params.ungapped_matrix, 2.0)
    keys = list(range(len(q_all)))
    _, targets = make_corpus(seed)
    jflat, jstarts = jax_build_masked_flat(targets, params)
    np.testing.assert_array_equal(flat, jflat)
    np.testing.assert_array_equal(starts, jstarts)
    got = pd.device_prefilter(q_all, keys, bias80, flat, starts, params,
                              SimilarKmerEnumerator(seed_m.scores), seed_m,
                              ungapped_m, device="cpu")
    want = jpd.device_prefilter(q_all, keys, bias80, jflat, jstarts, params,
                                JaxEnumerator(seed_m.scores), seed_m,
                                ungapped_m, backend="numpy")
    n = 0
    for k in keys:
        g = [(h.target, h.score, h.diagonal) for h in got[k]]
        assert g == [(h.target, h.score, h.diagonal) for h in want[k]], k
        n += len(g)
    assert n > 0


# ------------------------------------------------- the wrappers' host logic

def _chunk_counts(gj, chunk):
    """The number of hits in each target chunk of `chunk` positions."""
    return np.bincount(np.asarray(gj) // chunk).tolist()


def test_match_pairs_chunks_and_emit_splits(monkeypatch):
    """Target chunks of three tiles and a hit buffer of five hits give the
    oracle's hit set (chunk and buffer bounds never change output); each
    chunk with more than five hits runs again."""
    params, seed_m, _, _, batch, flat, _, bval = _case(5, mask=True,
                                                       n_targets=200,
                                                       n_queries=30)
    thr = params.kmer_threshold()
    oracle = pd.match_pairs_numpy(batch, flat, bval, seed_m.scores, thr)
    monkeypatch.setattr(pd, "MAX_CHUNK", 3 * pd.TILE_T)
    monkeypatch.setattr(pd, "HIT_CAPACITY", 5)
    monkeypatch.setattr(pd, "PLAIN_MAX_ELEMS", 1)
    before = _counted(*LAUNCHES)
    got = pairs(*pd.match_pairs(batch, flat, bval, seed_m.scores, thr,
                                device="cpu"))
    reruns = _counted(*LAUNCHES)[1] - before[1]
    per_chunk = _chunk_counts(oracle[1], 3 * pd.TILE_T)
    assert got == pairs(*oracle) and len(got) > 20 and len(per_chunk) > 2
    assert reruns == sum(n > 5 for n in per_chunk) > 0


def test_invalid_inputs_raise():
    params, seed_m, _, _, batch, flat, _, bval = _case(0)
    bad = flat.copy()
    bad[3] = 21
    with pytest.raises(ValueError, match="target letters"):
        pd.match_pairs(batch, bad, bval, seed_m.scores,
                       params.kmer_threshold(), device="cpu")
    with pytest.raises(ValueError, match="offsets"):
        pd.pad_offsets(range(7))
    assert pd.pad_offsets([0, 2]) == (0, 2, 0, 0, 0, 0)
    # the kernel wrapper's layout checks (run before a launch)
    inputs = pd.dense_inputs(batch, flat, bval, seed_m.scores,
                             params.kmer_threshold(), "cpu")
    compacted = pd.compact_rows(inputs[0], inputs[1])
    buf = pd.new_hit_buffer(4, "cpu")
    offs = pd.pad_offsets(inputs[4])
    pd._check_inputs(compacted, *inputs[2:4], offs, *buf)
    with pytest.raises(ValueError, match="gi and gj"):
        pd._check_inputs(compacted, *inputs[2:4], offs, buf[0], buf[1][:3],
                         buf[2])
    with pytest.raises(ValueError, match="cursor must be a contiguous"):
        pd._check_inputs(compacted, *inputs[2:4], offs, *buf[:2],
                         buf[2].int())
    with pytest.raises(ValueError, match="multiple of 128"):
        pd._check_inputs((compacted[0][:64], compacted[1][:64],
                          compacted[2][:64]), *inputs[2:4], offs, *buf)
    with pytest.raises(ValueError, match="tval length"):
        pd._check_inputs(compacted, inputs[2], inputs[3][:100], offs, *buf)


# --------------------------------------------------- the kernels on a card

# name -> (seed, mask, corpus kwargs) of the `cuda` cases (chip_smoke.py
# phase 4 runs them too); zero_hits is built by cuda_case
CUDA_CASES = {f"seed{s}_mask{int(m)}": (s, m, {}) for s in (0, 1, 2)
              for m in (False, True)}
CUDA_CASES["multichunk"] = (5, True, dict(n_targets=300, n_queries=40))
CUDA_CASES["zero_hits"] = None
CUDA_CASES.update(dict.fromkeys(EDGE_CASES))


def cuda_case(name):
    """(params, seed matrix, batch, masked flat, boundary validity) of a
    CUDA_CASES entry. Every case has pad and invalid rows (the zero_hits
    query is all X)."""
    if name in EDGE_CASES:
        return edge_case(name)
    if name == "zero_hits":
        params = PrefilterParams(mask=False)
        seed_m = load_matrix(params.seed_matrix, 8.0)
        q_all = [np.full(12, pd.X_IDX, dtype=np.int64)]
        batch = pd.build_query_batch(q_all, [0], [np.zeros(12)], params)
        t = np.random.default_rng(9).integers(0, 20, 900).astype(np.uint8)
        flat, starts = build_masked_flat([t[:400], t[400:]], params)
        return (params, seed_m, batch, flat,
                pd.target_boundary_valid(starts, batch.span))
    seed, mask, kw = CUDA_CASES[name]
    params, seed_m, _, _, batch, flat, _, bval = _case(seed, mask, **kw)
    return params, seed_m, batch, flat, bval


def match_pairs_small_bounds(batch, flat, bval, scores, kmer_thr):
    """match_pairs on the card with 3-tile target chunks and a hit buffer
    of 17 hits, so that it walks several chunks and runs some again: its
    hit pairs, and the launches and reruns it made."""
    saved = pd.MAX_CHUNK, pd.HIT_CAPACITY
    before = _counted(*LAUNCHES)
    pd.MAX_CHUNK, pd.HIT_CAPACITY = 3 * pd.TILE_T, 17
    try:
        got = pairs(*pd.match_pairs(batch, flat, bval, scores, kmer_thr,
                                    device="cuda"))
    finally:
        pd.MAX_CHUNK, pd.HIT_CAPACITY = saved
    after = _counted(*LAUNCHES)
    return got, (after[0] - before[0], after[1] - before[1])


def _case_inputs(case, device="cpu"):
    """(params, seed matrix, batch, flat, bval, inputs) of a `cuda` case,
    inputs its dense_inputs on `device`."""
    params, seed_m, batch, flat, bval = cuda_case(case)
    inputs = pd.dense_inputs(batch, flat, bval, seed_m.scores,
                             params.kmer_threshold(), device)
    return params, seed_m, batch, flat, bval, inputs


def _oracle(case_parts):
    params, seed_m, batch, flat, bval = case_parts[:5]
    return pairs(*pd.match_pairs_numpy(batch, flat, bval, seed_m.scores,
                                       params.kmer_threshold()))


@pytest.mark.parametrize("case", list(CUDA_CASES))
def test_compacted_counts_equal_plain(case):
    """The plain pass over the compacted rows, its hits counted per (target
    tile, query tile), equals the tile sums of the plain hit mask of all
    rows on every `cuda` case: compaction drops no row that can hit."""
    *_, inputs = _case_inputs(case)
    want = torch.zeros_like(tile_counts([], [], inputs))
    for c0, mask in pd._plain_blocks(*inputs[:4], inputs[4]):
        w = mask.shape[1] // pd.TILE_T
        want[c0 // pd.TILE_T:c0 // pd.TILE_T + w] += mask.reshape(
            want.shape[1], pd.TILE_Q, w, pd.TILE_T).sum(dim=(1, 3)).T
    gi, gj, n = plain_pass(inputs, 1 << 18)
    assert torch.equal(tile_counts(gi[:n], gj[:n], inputs), want)
    assert (n == 0) == (case == "zero_hits")


@pytest.mark.parametrize("capacity", ["ample", "short"])
@pytest.mark.parametrize("case", list(CUDA_CASES))
def test_plain_hits_equal_oracle(case, capacity):
    """chunk_hits on the CPU (the plain pass) equals the numpy oracle as a
    set on every `cuda` case, into a buffer with room to spare and into
    one of half the hits, which runs the chunk again (counted)."""
    parts = _case_inputs(case)
    want = _oracle(parts)
    cap = len(want) + 7 if capacity == "ample" else len(want) // 2
    before = _counted(*LAUNCHES)
    gi, gj = pd.chunk_hits(pd.compact_rows(*parts[5][:2]), *parts[5][2:],
                           pd.new_hit_buffer(cap, "cpu"))
    reruns = _counted(*LAUNCHES)[1] - before[1]
    assert gi.dtype == torch.int32 and gj.dtype == torch.int64
    assert pairs(gi, gj) == want
    assert reruns == int(cap < len(want))
    assert (capacity == "short" and case != "zero_hits") == (reruns == 1)


@pytest.mark.parametrize("capacity", ["zero", "exact", "one_short"])
@pytest.mark.parametrize("case", [f"seed{s}_mask{m}" for s in (0, 1, 2)
                                  for m in (0, 1)])
def test_hit_capacity_edges(case, capacity):
    """The plain pass into a buffer of 0 hits, of exactly the hits and of
    one less: the cursor counts every hit, the first min(n, capacity)
    slots hold distinct hits of the oracle and nothing lands past them;
    chunk_hits reruns only where the hits overflow, and returns the
    oracle's set either way."""
    parts = _case_inputs(case)
    want = _oracle(parts)
    n = len(want)
    cap = {"zero": 0, "exact": n, "one_short": n - 1}[capacity]
    gi, gj, cursor = pd.new_hit_buffer(cap + 3, "cpu")
    gi.fill_(-5)
    gj.fill_(-5)
    pd.prefilter_dense_hits_plain(pd.compact_rows(*parts[5][:2]),
                                  *parts[5][2:], gi[:cap], gj[:cap], cursor)
    assert int(cursor.item()) == n > 0
    written = pairs(gi[:cap], gj[:cap])
    assert len(set(written)) == cap and set(written) <= set(want)
    assert gi[cap:].tolist() == gj[cap:].tolist() == [-5] * 3
    before = _counted(*LAUNCHES)
    got = pd.chunk_hits(pd.compact_rows(*parts[5][:2]), *parts[5][2:],
                        pd.new_hit_buffer(cap, "cpu"))
    assert pairs(*got) == want
    assert _counted(*LAUNCHES)[1] - before[1] == int(capacity != "exact")


@pytest.mark.parametrize("capacity", ["default", "tiny"])
def test_dense_hit_reruns_counted(capacity, monkeypatch):
    """match_pairs counts one dense_hit_reruns for each target chunk whose
    hits overflow the hit buffer: none at HIT_CAPACITY, and at a buffer of
    3 hits every chunk with more; dense_hits counts the hits."""
    parts = cuda_case("multichunk")
    params, seed_m, batch, flat, bval = parts
    oracle = pd.match_pairs_numpy(batch, flat, bval, seed_m.scores,
                                  params.kmer_threshold())
    chunk = 4 * pd.TILE_T
    monkeypatch.setattr(pd, "MAX_CHUNK", chunk)
    if capacity == "tiny":
        monkeypatch.setattr(pd, "HIT_CAPACITY", 3)
    names = ("dense_hit_reruns", "dense_hits")
    before = _counted(*names)
    got = pairs(*pd.match_pairs(batch, flat, bval, seed_m.scores,
                                params.kmer_threshold(), device="cpu"))
    reruns, hits = (a - b for a, b in zip(_counted(*names), before))
    per_chunk = _chunk_counts(oracle[1], chunk)
    assert got == pairs(*oracle) and hits == len(got)
    assert len(per_chunk) > 2
    assert reruns == (sum(n > 3 for n in per_chunk) if capacity == "tiny"
                      else 0)
    if capacity == "tiny":
        assert reruns > 0


def test_hit_buffer_kept_per_device(monkeypatch):
    """hit_buffer allocates once per device and hands the same tensors to
    every later call, and allocates anew when HIT_CAPACITY changes."""
    monkeypatch.setattr(pd, "_hit_buffers", {})
    monkeypatch.setattr(pd, "HIT_CAPACITY", 11)
    first = pd.hit_buffer("cpu")
    assert [t.numel() for t in first] == [11, 11, 1]
    assert [t.dtype for t in first] == [torch.int32, torch.int32,
                                        torch.int64]
    assert all(a is b for a, b in zip(first, pd.hit_buffer(
        torch.device("cpu"))))
    monkeypatch.setattr(pd, "HIT_CAPACITY", 12)
    assert pd.hit_buffer("cpu")[0].numel() == 12


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compacted_emit_matches_jax_extract(seed):
    """The plain pass over the compacted rows against np.nonzero of the
    JAX package's hit masks (_extract_fn, a plain jit) on the tiles with
    hits, as a set."""
    import jax.numpy as jnp
    from spacepharer_tpu.ops import prefilter_dense as jpd
    params, seed_m, _, _, batch, flat, _, bval = _case(seed)
    thr = params.kmer_threshold()
    inputs = pd.dense_inputs(batch, flat, bval, seed_m.scores, thr, "cpu")
    gi, gj, n = plain_pass(inputs, 1 << 16)
    counts = tile_counts(gi[:n], gj[:n], inputs)
    nqt = counts.shape[1]
    tiles = torch.nonzero(counts.flatten()).flatten()
    qt = (tiles % nqt).numpy().astype(np.int32)
    tt = (tiles // nqt).numpy().astype(np.int32)
    masks = np.asarray(jpd._extract_fn(len(qt))(
        *_jax_tiles(batch, seed_m.scores, thr, inputs, bval),
        jnp.asarray(qt), jnp.asarray(tt)))
    b, ii, jj = np.nonzero(masks)
    assert pairs(gi[:n], gj[:n]) == pairs(qt[b] * pd.TILE_Q + ii,
                                          tt[b] * pd.TILE_T + jj)
    assert n > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CUDA_CASES))
def test_cuda_kernels_match_plain(case):
    """The kernel's hits, sorted, equal the plain pass's on the same card
    tensors; into a buffer of half the hits it counts them all and writes
    distinct hits into every slot it has, and chunk_hits then runs the
    chunk again into one of exactly the hits; match_pairs on the card,
    walking several target chunks and rerunning some, equals the numpy
    oracle."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    parts = _case_inputs(case, "cuda")
    inputs = parts[5]
    want = _oracle(parts)
    compacted = pd.compact_rows(inputs[0], inputs[1])
    gi, gj, n = plain_pass(inputs, len(want) + 1)
    assert n == len(want) and pairs(gi[:n], gj[:n]) == want
    before = _counted(*LAUNCHES)
    buf = pd.new_hit_buffer(len(want) + 1, "cuda")
    buf[2].fill_(12345)          # the launch zeroes the cursor
    pd.prefilter_dense_hits(compacted, *inputs[2:], *buf)
    assert int(buf[2].item()) == n
    assert pairs(buf[0][:n], buf[1][:n]) == want
    half = pd.new_hit_buffer(n // 2, "cuda")
    pd.prefilter_dense_hits(compacted, *inputs[2:], *half)
    assert int(half[2].item()) == n
    written = pairs(half[0], half[1])
    assert len(set(written)) == n // 2 and set(written) <= set(want)
    got = pd.chunk_hits(compacted, *inputs[2:], pd.new_hit_buffer(
        n // 2, "cuda"))
    assert pairs(*got) == want
    after = _counted(*LAUNCHES)
    reran = int(n // 2 < n)
    assert (after[0] - before[0], after[1] - before[1]) == (3 + reran, reran)
    assert (n == 0) == (case == "zero_hits")

    got, _ = match_pairs_small_bounds(parts[2], parts[3], parts[4],
                                      parts[1].scores,
                                      parts[0].kmer_threshold())
    assert got == want
