"""The pair-list entry of the port's SW scorer B1 (ops/sw_packed.py:
pack_pair_queries, sw_pairs_plain, sw_pairs and device_pair_scores)
against the JAX package, on seeded numpy inputs.

The references are the JAX package's packed Pallas kernel in interpret
mode (device_allpairs_scores, as tests/test_torch_sw_packed.py reaches
it), read at the listed pairs, and its bucketed scan
(score_pairs_bucketed, the CPU path of its scoring engine). Scores are
integers, so every comparison is exact. The `cuda` cases hold the CUDA
kernel against its plain version on the card and skip without one; JAX
is imported only where the JAX side runs. The GPU scoring engine's
branch of predictmatch._candidate_scores is run here on CPU tensors: it
must go through device_pair_scores, which builds each query's composition
bias with its profile (never _query_bias_i8 on the host), and never
through the dense [key block x target union] entry.
"""
import glob
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from spacepharer_tpu_torch.io.setdb import SetDB
from spacepharer_tpu_torch.logging import timings
from spacepharer_tpu_torch.ops import sw_packed
from spacepharer_tpu_torch.ops.matrices import load_matrix
from spacepharer_tpu_torch.pipeline import predictmatch as pm


def _counted(*names):
    """The registry's totals (logging.timings) of the named counters."""
    got = timings()
    return tuple(got.get(n, 0) for n in names)


def _make(seed, q_lens, t_lens, per_query, alphabet=20, bias="random",
          gaps=(16, 2), shuffle=True):
    """(queries, targets, biases or None, cand_t int64, cand_off int64,
    gap_open, gap_extend): per_query(rng) candidate targets for each
    query, drawn with repeats and left unsorted when `shuffle`."""
    rng = np.random.default_rng(seed)
    qs = [rng.integers(0, alphabet, n) for n in q_lens]
    ts = [rng.integers(0, alphabet, n) for n in t_lens]
    if bias == "random":
        biases = [rng.integers(-3, 4, len(q)) for q in qs]
    elif bias == "zero":
        biases = [np.zeros(len(q), dtype=np.int64) for q in qs]
    else:
        biases = None
    cand = []
    for _ in qs:
        c = rng.integers(0, len(ts), int(per_query(rng)))
        cand.append(c if shuffle else np.sort(c))
    cand_off = np.zeros(len(qs) + 1, dtype=np.int64)
    np.cumsum([len(c) for c in cand], out=cand_off[1:])
    cand_t = (np.concatenate(cand) if cand_off[-1]
              else np.zeros(0, np.int64)).astype(np.int64)
    return qs, ts, biases, cand_t, cand_off, gaps[0], gaps[1]


def _self_aligned(seed):
    """A 530-row query that is the first 530 letters of a 560-letter
    target, beside short ones: the best path runs down the diagonal through
    the corners where the pair kernel's stripes (16 rows) and column
    blocks (16 columns, 256-column passes) meet."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 20, 560)
    qs = [t[:530].copy(), rng.integers(0, 20, 20), rng.integers(0, 20, 40)]
    ts = [t, rng.integers(0, 20, 300), rng.integers(0, 20, 9)]
    biases = [rng.integers(-3, 4, len(q)) for q in qs]
    cand_t = np.array([0, 1, 0, 2, 0, 1], dtype=np.int64)
    cand_off = np.array([0, 2, 4, 6], dtype=np.int64)
    return qs, ts, biases, cand_t, cand_off, 16, 2


CASES = {
    # past one and two 16-row stripes (17, 32, 33, 40 rows), with a
    # stripe-exact query and an empty one among them
    "long_queries": lambda: _make(
        0, [17, 33, 40, 5, 16, 32, 0, 48], [30, 64, 7, 90, 45, 12],
        lambda r: r.integers(1, 6)),
    # one-letter targets (and an empty one) beside longer ones
    "one_letter_targets": lambda: _make(
        1, [9, 23, 12, 18], [1, 1, 1, 0, 25, 1, 60],
        lambda r: r.integers(2, 7)),
    # X (letter 20) on both sides, other gap penalties
    "x_letters": lambda: _make(
        2, [12, 20, 7, 35], [40, 22, 9, 70, 3], lambda r: r.integers(2, 6),
        alphabet=21, gaps=(10, 1)),
    "zero_bias": lambda: _make(
        3, [10, 14, 21, 8], [50, 33, 17, 80], lambda r: r.integers(1, 5),
        bias="zero"),
    "no_bias": lambda: _make(
        4, [11, 26, 6], [44, 19, 73], lambda r: r.integers(1, 5),
        bias=None),
    # each query's candidates sorted, targets repeated within a query
    "duplicated_sorted": lambda: _make(
        5, [13, 19, 9], [20, 35, 8, 61], lambda r: 6, shuffle=False),
    "empty_pair_list": lambda: _make(
        6, [10, 12, 17], [20, 30], lambda r: 0),
    # many short queries with a few candidates each: every 128-pair block
    # of the kernel mixes tens of queries, as in the GPU engine's corpus
    "many_queries": lambda: _make(
        7, np.random.default_rng(70).integers(3, 24, 160),
        np.random.default_rng(71).integers(5, 120, 40),
        lambda r: r.integers(0, 5)),
    # targets of 600-1,500 residues beside short ones, queries of 2 and 7
    # stripes among them: at the default split both the tail (a
    # half-warp a pair, stripe after stripe) and the bulk take pairs
    "long_targets": lambda: _make(
        8, [25, 110, 12, 9], [600, 1500, 30, 900, 8, 41],
        lambda r: r.integers(2, 5)),
    "self_aligned": lambda: _self_aligned(9),
}


def _pairs(cand_off):
    return np.repeat(np.arange(len(cand_off) - 1), np.diff(cand_off))


def _jax_dense(qs, ts, biases, go, ge):
    """The JAX package's packed kernel (interpret mode), every query x
    every target."""
    from spacepharer_tpu.ops import sw_packed as jax_sw
    m = load_matrix("VTML40.out", 2.0)
    return np.asarray(jax_sw.device_allpairs_scores(
        qs, ts, m.scores, bias_list=biases, gap_open=go, gap_extend=ge,
        interpret=True))


def _packed_targets(ts):
    t_off = np.zeros(len(ts) + 1, dtype=np.int64)
    np.cumsum([len(t) for t in ts], out=t_off[1:])
    t_flat = (np.concatenate(ts) if t_off[-1] else np.zeros(0)).astype(
        np.uint8)
    return t_flat, t_off


def _plain(qs, ts, biases, cand_t, cand_off, go, ge):
    """sw_pairs_plain called on CPU tensors from the host packs."""
    m = load_matrix("VTML40.out", 2.0)
    qp = sw_packed.pack_pair_queries(qs, m.scores, biases)
    t_flat, t_off = _packed_targets(ts)
    return sw_packed.sw_pairs_plain(
        qp["prof"], qp["q_stripe"], qp["q_len"], torch.from_numpy(t_flat),
        torch.from_numpy(t_off),
        torch.from_numpy(_pairs(cand_off).astype(np.int32)),
        torch.from_numpy(cand_t.astype(np.int32)), go, ge)


@pytest.mark.parametrize("case", list(CASES))
def test_sw_pairs_plain_matches_jax(case):
    qs, ts, biases, cand_t, cand_off, go, ge = CASES[case]()
    got = _plain(qs, ts, biases, cand_t, cand_off, go, ge)
    assert got.dtype == torch.int32 and got.shape == (len(cand_t),)
    ref = _jax_dense(qs, ts, biases, go, ge)[_pairs(cand_off), cand_t]
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("case", list(CASES))
def test_device_pair_scores_matches_jax(case):
    """device_pair_scores on the CPU (the plain version) against the JAX
    kernel read at the pairs, and against the JAX package's bucketed
    scan on the same pair list."""
    from spacepharer_tpu.ops.sw_tpu import score_pairs_bucketed
    qs, ts, biases, cand_t, cand_off, go, ge = CASES[case]()
    m = load_matrix("VTML40.out", 2.0)
    got = sw_packed.device_pair_scores(qs, biases, *_packed_targets(ts),
                                       cand_t, cand_off, m.scores, go, ge,
                                       device="cpu")
    assert got.dtype == np.int64 and got.shape == (len(cand_t),)
    pair_q = _pairs(cand_off)
    np.testing.assert_array_equal(
        got, _jax_dense(qs, ts, biases, go, ge)[pair_q, cand_t])
    if len(cand_t):
        scan = score_pairs_bucketed(
            list(zip(pair_q.tolist(), cand_t.tolist())), qs, ts, m.scores,
            biases, go, ge)
        np.testing.assert_array_equal(got, np.asarray(scan))


def test_device_pair_scores_in_pair_chunks(monkeypatch):
    """Pair runs that start and end inside a query's candidates (and a
    query without any) give the scores of one run."""
    qs, ts, biases, cand_t, cand_off, go, ge = CASES["many_queries"]()
    m = load_matrix("VTML40.out", 2.0)
    args = (qs, biases, *_packed_targets(ts), cand_t, cand_off, m.scores,
            go, ge)
    whole = sw_packed.device_pair_scores(*args, device="cpu")
    monkeypatch.setattr(sw_packed, "PAIR_CHUNK", 7)
    np.testing.assert_array_equal(
        sw_packed.device_pair_scores(*args, device="cpu"), whole)


def test_pack_pair_queries_layout():
    """Stripes of 16 rows per query, bias folded in, -128 past a query's
    end and at letters the matrix lacks; out-of-range scores raise."""
    m = load_matrix("VTML40.out", 2.0)
    qs = [np.arange(17) % 21, np.zeros(0, np.int64), np.array([20, 3])]
    biases = [np.full(17, 2), np.zeros(0, np.int64), np.array([-1, 1])]
    qp = sw_packed.pack_pair_queries(qs, m.scores, biases)
    assert qp["prof"].shape == (3, sw_packed.A_PAD, sw_packed.STRIPE)
    assert qp["prof"].dtype == torch.int8
    assert qp["q_stripe"].tolist() == [0, 2, 2]
    assert qp["q_len"].tolist() == [17, 0, 2]
    prof = qp["prof"].numpy().astype(np.int64)
    for j in range(17):
        np.testing.assert_array_equal(prof[j // 16, :21, j % 16],
                                      m.scores[j % 21] + 2)
    assert (prof[1, :, 1:] == sw_packed.PROF8_NEG).all()
    assert (prof[:, 21:, :] == sw_packed.PROF8_NEG).all()
    np.testing.assert_array_equal(prof[2, :21, 0], m.scores[20] - 1)
    with pytest.raises(ValueError, match="int8"):
        sw_packed.pack_pair_queries([np.array([0])], m.scores * 20)
    with pytest.raises(ValueError, match="one bias per query residue"):
        sw_packed.pack_pair_queries([np.array([0, 1])], m.scores,
                                    [np.array([1])])


def _pair_tensors(case):
    """(sw_pairs' CPU tensors, gap_open, gap_extend) of a CASES entry."""
    qs, ts, biases, cand_t, cand_off, go, ge = CASES[case]()
    m = load_matrix("VTML40.out", 2.0)
    qp = sw_packed.pack_pair_queries(qs, m.scores, biases)
    t_flat, t_off = _packed_targets(ts)
    return (qp["prof"], qp["q_stripe"], qp["q_len"],
            torch.from_numpy(np.concatenate(
                [t_flat, np.zeros(sw_packed.T_PAD, np.uint8)])),
            torch.from_numpy(t_off),
            torch.from_numpy(_pairs(cand_off).astype(np.int32)),
            torch.from_numpy(cand_t.astype(np.int32))), go, ge


SPLITS = {"default": None, "all_tail": 0, "all_bulk": (1 << 63) - 1}


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("case", ["long_targets", "long_queries",
                                  "many_queries"])
def test_pair_order_places_every_pair_once(case, split):
    """The pair kernel's order: every pair at one sorted position, the
    pairs of serial work >= the split first, the bulk by stripes then
    target length, scratch lines end to end for exactly the pairs that
    hand rows down, and a score computed at position i and written to
    out[order[i]] lands at its pair's position."""
    args, go, ge = _pair_tensors(case)
    prof, q_stripe, q_len, t_seqs, t_off, pair_q, pair_t = args
    work_at = sw_packed.PAIR_TAIL_WORK if SPLITS[split] is None \
        else SPLITS[split]
    key, need, stats = sw_packed.pair_keys(q_len, t_off, pair_q, pair_t,
                                           work_at)
    order, end = sw_packed.pair_order(key, need)
    n = pair_q.numel()
    assert sorted(order.tolist()) == list(range(n))
    q_lens = q_len.long()[pair_q.long()][order]
    t_lens = (t_off[1:] - t_off[:-1])[pair_t.long()][order]
    stripes = (q_lens + sw_packed.STRIPE - 1) // sw_packed.STRIPE
    work = stripes * t_lens
    n_tail, cells = stats.tolist()
    assert cells == int((q_lens * t_lens).sum())
    assert bool((work[:n_tail] >= work_at).all())
    assert bool((work[n_tail:] < work_at).all())
    assert work[:n_tail].tolist() == sorted(work[:n_tail].tolist(),
                                            reverse=True)
    bits = sw_packed.KEY_LEN_BITS
    short = (q_lens[n_tail:] > sw_packed.SHORT_ROWS).long()
    bulk = (stripes[n_tail:].clamp(max=3) << bits + 1 | short << bits
            | t_lens[n_tail:].clamp(max=(1 << bits) - 1)).tolist()
    assert max(bulk, default=0) < sw_packed.TAIL_KEY
    assert bulk == sorted(bulk, reverse=True)
    if split == "default":
        assert 0 < n_tail < n or case != "long_targets"
    cols = sw_packed.LINE_COLS
    lines = torch.where(q_lens > sw_packed.STRIPE,
                        (t_lens + cols - 1) // cols * cols, 0)
    assert torch.equal(end, torch.cumsum(lines, 0))
    scored = sw_packed.sw_pairs_plain(prof, q_stripe, q_len, t_seqs, t_off,
                                      pair_q[order].contiguous(),
                                      pair_t[order].contiguous(), go, ge)
    out = torch.full((n,), -1, dtype=torch.int32)
    out[order] = scored
    np.testing.assert_array_equal(
        out.numpy(), sw_packed.sw_pairs_plain(*args, go, ge).numpy())


def test_device_pair_scores_rejects_letters_outside_the_matrix():
    m = load_matrix("VTML40.out", 2.0)
    with pytest.raises(ValueError, match="alphabet"):
        sw_packed.device_pair_scores(
            [np.array([1, 2])], None, np.array([3, 21], np.uint8),
            np.array([0, 2]), np.array([0]), np.array([0, 1]), m.scores,
            device="cpu")


# -------------------------------------------- the GPU engine's card branch

def _card_branch_on_cpu(monkeypatch):
    """Report a card, run device_pair_scores' plain version in its place
    (recording the device each call asked for, and that it was handed the
    expected-score table and no biases) and make the dense [block x
    union] entry and the host bias raise."""
    asked = []
    real = sw_packed.device_pair_scores

    def on_cpu(q_list, biases, *a, device, expected, **kw):
        assert biases is None and expected is not None
        asked.append(device)
        return real(q_list, biases, *a, device="cpu", expected=expected,
                    **kw)

    def dense(*a, **kw):
        raise AssertionError("the GPU branch built a [block x union] matrix")

    def host_bias(*a, **kw):
        raise AssertionError("the GPU branch built the bias on the host")

    monkeypatch.setattr(pm, "_accelerator_present", lambda: True)
    monkeypatch.setattr(sw_packed, "device_pair_scores", on_cpu)
    monkeypatch.setattr(sw_packed, "device_allpairs_scores", dense)
    monkeypatch.setattr(pm, "_query_bias_i8", host_bias)
    return asked


@pytest.mark.parametrize("packed", [True, False], ids=["t_packed", "t_aa"])
def test_candidate_scores_card_branch_scores_pairs(monkeypatch, packed):
    """_candidate_scores on a card (no mesh) hands the pair list to
    device_pair_scores, with the search's packed targets or its per-target
    views, and gives the scores of its CPU branch (the bucketed scan, asked
    for on the CPU, fed _query_bias_i8's biases: the card branch computes
    the same biases with its profiles)."""
    qs, ts, _, cand_t, cand_off, _, _ = CASES["many_queries"]()
    m40 = load_matrix("VTML40.out", 2.0)
    params = pm.PredictParams()
    t_flat, t_off = _packed_targets(ts)
    t_aa = [t_flat[t_off[i]:t_off[i + 1]] for i in range(len(ts))]
    scan = pm._candidate_scores(qs, t_aa, cand_t, cand_off,
                                pm._query_bias_i8(qs, m40), m40,
                                replace(params, device="cpu"))
    asked = _card_branch_on_cpu(monkeypatch)
    got = pm._candidate_scores(qs, t_aa, cand_t, cand_off, None, m40,
                               params,
                               t_packed=(t_flat, t_off) if packed else None)
    assert asked == ["cuda"]
    np.testing.assert_array_equal(got, scan)


def test_card_branch_gives_the_golden_bytes(golden, monkeypatch):
    """predict_match with the GPU engine forced on and its card branch
    run on CPU tensors: the golden result.tsv, both searches through
    device_pair_scores with the bias built beside the profile (the plain
    version of csrc/pair_profile.cu), none on the host."""
    (qpath,) = {os.path.realpath(p) for p in
                glob.glob(os.path.join(golden, "tmp", "*", "qsetdb"))}
    dbs = [SetDB.load(p) for p in (qpath, os.path.join(golden, "targets"),
                                   os.path.join(golden, "targets_rev"))]
    asked = _card_branch_on_cpu(monkeypatch)
    res = pm.predict_match(*dbs, pm.PredictParams(use_tpu=True))
    with open(os.path.join(golden, "result.tsv")) as fh:
        assert res.text == fh.read()
    assert asked == ["cuda", "cuda"]


# ---------------------------------------------------------------- on a card

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_pair_kernel_matches_plain(case):
    _cuda_or_skip()
    qs, ts, biases, cand_t, cand_off, go, ge = CASES[case]()
    m = load_matrix("VTML40.out", 2.0)
    args = (qs, biases, *_packed_targets(ts), cand_t, cand_off, m.scores,
            go, ge)
    (before,) = _counted("sw_pairs_launches")
    got = sw_packed.device_pair_scores(*args, device="cuda")
    assert _counted("sw_pairs_launches")[0] > before or len(cand_t) == 0
    np.testing.assert_array_equal(
        got, sw_packed.device_pair_scores(*args, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("split", ["all_tail", "all_bulk"])
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_pair_kernel_forced_class_matches_plain(case, split,
                                                     monkeypatch):
    """Every pair in the tail (a half-warp a pair, lanes over column
    blocks), or every pair in the bulk (a thread a pair), gives the
    plain scores."""
    _cuda_or_skip()
    qs, ts, biases, cand_t, cand_off, go, ge = CASES[case]()
    m = load_matrix("VTML40.out", 2.0)
    args = (qs, biases, *_packed_targets(ts), cand_t, cand_off, m.scores,
            go, ge)
    monkeypatch.setattr(sw_packed, "PAIR_TAIL_WORK", SPLITS[split])
    np.testing.assert_array_equal(
        sw_packed.device_pair_scores(*args, device="cuda"),
        sw_packed.device_pair_scores(*args, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_pair_keys_match_plain(case):
    """The key pass on the card gives pair_keys_plain's keys, scratch
    needs and counts, at the default split and with every pair a tail
    pair."""
    _cuda_or_skip()
    args, _, _ = _pair_tensors(case)
    dev = torch.device("cuda")
    _, _, q_len, _, t_off, pair_q, pair_t = (x.to(dev) for x in args)
    for work_at in (sw_packed.PAIR_TAIL_WORK, 0):
        got = sw_packed.pair_keys(q_len, t_off, pair_q, pair_t, work_at)
        want = sw_packed.pair_keys_plain(q_len, t_off, pair_q, pair_t,
                                         work_at)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.cuda
def test_cuda_pair_kernel_split_launches_match_plain(monkeypatch):
    """A scratch budget of one int2 per launch gives every pair whose
    query is longer than one stripe a launch of its own."""
    _cuda_or_skip()
    qs, ts, biases, cand_t, cand_off, go, ge = CASES["long_queries"]()
    m = load_matrix("VTML40.out", 2.0)
    args = (qs, biases, *_packed_targets(ts), cand_t, cand_off, m.scores,
            go, ge)
    monkeypatch.setattr(sw_packed, "SCRATCH_BYTES", 8)
    long_pairs = int(np.sum(np.repeat([len(q) > sw_packed.STRIPE
                                       for q in qs], np.diff(cand_off))))
    (before,) = _counted("sw_pairs_launches")
    got = sw_packed.device_pair_scores(*args, device="cuda")
    assert _counted("sw_pairs_launches")[0] - before >= long_pairs
    np.testing.assert_array_equal(
        got, sw_packed.device_pair_scores(*args, device="cpu"))
