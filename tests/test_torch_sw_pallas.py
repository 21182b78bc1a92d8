"""The port's dense SW scorers B3 and B4 (ops/sw_pallas.py) against the
JAX package's Pallas kernels, run in interpret mode on the CPU.

Scores are integers, so every comparison is exact. The CPU cases run the
kernels' plain PyTorch versions; the `cuda` cases hold the CUDA kernel
(csrc/sw_dense.cu) against those plain versions on the card, on the
inputs of CUDA_CASES, which chip_smoke.py phase 5 also runs. JAX is
imported only where the JAX side runs.
"""
import numpy as np
import pytest
import torch

from spacepharer_tpu_torch.logging import timings
from spacepharer_tpu_torch.ops import sw_packed, sw_pallas
from spacepharer_tpu_torch.ops.align import _forward_pass
from spacepharer_tpu_torch.ops.matrices import load_matrix


def _counted(*names):
    """The registry's totals (logging.timings) of the named counters."""
    got = timings()
    return tuple(got.get(n, 0) for n in names)


NEG = -(10 ** 6)


def _matrix():
    return load_matrix("VTML40.out", 2.0)


def _pack(qs, ts, a_pad=32, lq=None, lt=None, q_mult=1, t_mult=1,
          biases=None):
    """(q_prof [Q, LQ, a_pad], q_len [Q, 1, 1], t_seqs [LT, T], t_len
    [1, T]) in the Pallas layout; Q and T padded with empty sequences to
    multiples of q_mult and t_mult."""
    m = _matrix()
    Q = -(-len(qs) // q_mult) * q_mult
    T = -(-len(ts) // t_mult) * t_mult
    lq = lq or max(max((len(q) for q in qs), default=1), 1)
    lt = lt or max(max((len(t) for t in ts), default=1), 1)
    prof = np.full((Q, lq, a_pad), NEG, np.int32)
    q_len = np.zeros((Q, 1, 1), np.int32)
    for i, q in enumerate(qs):
        p = m.scores[np.asarray(q, np.int64)].astype(np.int32)
        if biases is not None:
            p = p + np.asarray(biases[i], np.int32)[:, None]
        prof[i, :len(q), :min(a_pad, p.shape[1])] = p[:, :a_pad]
        q_len[i, 0, 0] = len(q)
    t_seqs = np.full((lt, T), 20, np.int32)
    t_len = np.zeros((1, T), np.int32)
    for i, t in enumerate(ts):
        t_seqs[:len(t), i] = t
        t_len[0, i] = len(t)
    return prof, q_len, t_seqs, t_len


def _case_one_query():
    """tests/test_sw_pallas.py::test_pallas_kernel_matches_host."""
    rng = np.random.default_rng(4)
    q = rng.integers(0, 20, 14)
    targets = [rng.integers(0, 20, rng.integers(20, 120)) for _ in range(12)]
    prof, qlen, t_seqs, t_len, _ = sw_pallas.pack_for_pallas(
        q, _matrix().scores, targets, lt_pad=128, t_tile=256)
    return prof[None], qlen.reshape(1, 1, 1), t_seqs, t_len, 16, 2


def _case_batch():
    """tests/test_sw_pallas.py::test_pallas_batch_matches_host."""
    rng = np.random.default_rng(4)
    qs = [rng.integers(0, 20, rng.integers(5, 30)) for _ in range(16)]
    ts = [rng.integers(0, 20, rng.integers(10, 100)) for _ in range(512)]
    return _pack(qs, ts, 32, 32, 128) + (16, 2)


def _case_ragged(a_pad, go, ge):
    """13 queries (one empty, one past a 16-row stripe) x 300 targets
    (one empty), letters X and, for A = 21, letters outside the profile
    (they score 0), with per-row bias."""
    rng = np.random.default_rng(9 + a_pad)
    qs = [rng.integers(0, 21, int(rng.integers(3, 16))) for _ in range(11)]
    qs = qs[:4] + [np.zeros(0, np.int64), rng.integers(0, 21, 40)] + qs[4:]
    ts = [rng.integers(0, 21, int(rng.integers(1, 70))) for _ in range(299)]
    ts.insert(7, np.zeros(0, np.int64))
    if a_pad == 21:
        ts[3][:4] = [25, -1, 21, 31]
    biases = [rng.integers(-3, 4, len(q)) for q in qs]
    return _pack(qs, ts, a_pad, biases=biases) + (go, ge)


def _case_long_query():
    """Queries of 2300, 17 and 16 rows (many stripes, just past one, one
    exactly) against targets up to 1800 columns, score far above 4096."""
    rng = np.random.default_rng(13)
    top = int(np.argmax(np.diag(_matrix().scores[:20, :20])))
    huge = np.full(2300, top, dtype=np.int64)
    qs = [huge, rng.integers(0, 21, 40), huge[:17], huge[:16]]
    ts = [huge[:1800].copy(), rng.integers(0, 21, 700),
          rng.integers(0, 21, 3)] + [rng.integers(0, 21, 90)
                                     for _ in range(70)]
    return _pack(qs, ts, 21) + (16, 2)


def _case_target_order(order):
    """Queries of 16 and 17 rows (exactly one stripe, just past it) and
    others against 40 targets in ascending, descending or equal length
    order: the kernel's sort must undo and keep each."""
    rng = np.random.default_rng({"ascending": 21, "descending": 22,
                                 "equal": 23}[order])
    qs = [rng.integers(0, 20, n) for n in (16, 17, 5, 33, 1, 12)]
    lens = (np.full(40, 37) if order == "equal"
            else np.sort(rng.integers(1, 90, 40)))
    if order == "descending":
        lens = lens[::-1]
    ts = [rng.integers(0, 21, int(n)) for n in lens]
    return _pack(qs, ts, 21) + (16, 2)


def _case_one_target():
    """T = 1: one target, a query past one stripe."""
    rng = np.random.default_rng(24)
    qs = [rng.integers(0, 20, n) for n in (3, 16, 17, 40)]
    return _pack(qs, [rng.integers(0, 20, 77)], 21) + (10, 1)


def _case_letters_outside():
    """Letters at and above A (21, 25, 31, 127, 255, 4096) and negative
    ones (-1, -7): all score 0, none reads the pad column."""
    rng = np.random.default_rng(25)
    qs = [rng.integers(0, 20, n) for n in (16, 17, 9)]
    ts = [rng.integers(0, 21, int(n)) for n in rng.integers(10, 60, 30)]
    bad = [21, 25, 31, 127, 255, 4096, -1, -7]
    for k, t in enumerate(ts[:8]):
        t[rng.integers(0, len(t), 3)] = bad[k]
    ts[8][:] = -1
    return _pack(qs, ts, 21) + (16, 2)


CASES = {
    "pallas_one_query": _case_one_query,
    "pallas_batch": _case_batch,
    "ragged_a32": lambda: _case_ragged(32, 16, 2),
    "ragged_a21_gap10_1": lambda: _case_ragged(21, 10, 1),
    "targets_ascending": lambda: _case_target_order("ascending"),
    "targets_descending": lambda: _case_target_order("descending"),
    "targets_equal": lambda: _case_target_order("equal"),
    "one_target": _case_one_target,
    "letters_outside": _case_letters_outside,
}
CUDA_CASES = list(CASES) + ["long_query"]


def cuda_case(name):
    """The numpy inputs of a `cuda` case: (q_prof, q_len, t_seqs, t_len,
    gap_open, gap_extend)."""
    return _case_long_query() if name == "long_query" else CASES[name]()


def _jax_batch(prof, q_len, t_seqs, t_len, go, ge):
    """sw_scores_pallas_batch in interpret mode, on inputs padded to its
    8-query and 256-target tiles; [Q, T]."""
    from spacepharer_tpu.ops.sw_pallas import sw_scores_pallas_batch
    Q, T = prof.shape[0], t_seqs.shape[1]
    Qp, Tp = -(-Q // 8) * 8, -(-T // 256) * 256
    pp = np.full((Qp,) + prof.shape[1:], NEG, np.int32)
    pp[:Q] = prof
    ql = np.zeros((Qp, 1, 1), np.int32)
    ql[:Q] = q_len
    ts = np.full((t_seqs.shape[0], Tp), 20, np.int32)
    ts[:, :T] = t_seqs
    tl = np.zeros((1, Tp), np.int32)
    tl[:, :T] = t_len
    return np.asarray(sw_scores_pallas_batch(
        pp, ql, ts, tl, gap_open=go, gap_extend=ge, interpret=True))[:Q, :T]


def _torch(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _oracle(prof, q_len, t_seqs, t_len, qi, ti, go, ge):
    """The exact host forward pass of one pair, from the packed inputs
    (letters outside the profile score 0)."""
    q = int(q_len.reshape(-1)[qi])
    n = int(t_len.reshape(-1)[ti])
    if q == 0 or n == 0:
        return 0
    letters = t_seqs[:n, ti].astype(np.int64)
    a = prof.shape[2]
    ok = (letters >= 0) & (letters < a)
    sub = np.where(ok[:, None], prof[qi, :q][:, np.where(ok, letters, 0)].T,
                   0).astype(np.int64)
    return _forward_pass(sub, go, ge)[0]


@pytest.mark.parametrize("case", list(CASES))
def test_batch_plain_matches_pallas(case):
    prof, q_len, t_seqs, t_len, go, ge = CASES[case]()
    ref = _jax_batch(prof, q_len, t_seqs, t_len, go, ge)
    got = sw_pallas.sw_scores_batch(*_torch(prof, q_len, t_seqs, t_len),
                                    go, ge).numpy()
    assert got.dtype == np.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    rng = np.random.default_rng(0)
    for _ in range(40):
        qi = int(rng.integers(0, ref.shape[0]))
        ti = int(rng.integers(0, ref.shape[1]))
        assert got[qi, ti] == _oracle(prof, q_len, t_seqs, t_len, qi, ti,
                                      go, ge), (qi, ti)


@pytest.mark.parametrize("case", list(CASES))
def test_packed_plain_matches_pallas(case):
    """The kernel's input layout on the CPU: pack_targets' runs (sorted
    longest first, 16-aligned, letters outside [0, A) as A, pads as
    A + 1) are held, and the plain scan through them (pad letters
    scanned) and back equals the Pallas kernel in interpret mode and
    sw_scores_batch_plain, exactly."""
    prof, q_len, t_seqs, t_len, go, ge = CASES[case]()
    A, T = prof.shape[2], t_seqs.shape[1]
    args = _torch(prof, q_len, t_seqs, t_len)
    packed = sw_pallas.pack_targets(args[2].t(), args[3], A)
    lens = t_len.reshape(-1)
    order = packed.order.numpy()
    assert sorted(order.tolist()) == list(range(T))
    np.testing.assert_array_equal(packed.lens.numpy(), lens[order])
    assert np.all(np.diff(packed.lens.numpy()) <= 0)
    # stable: equal lengths keep the caller's order
    same = np.diff(packed.lens.numpy()) == 0
    assert np.all(np.diff(order)[same] > 0)
    off = packed.off.numpy()
    assert np.all(off % sw_packed.T_ALIGN == 0)
    seqs = packed.seqs.numpy()
    for s in range(T):
        n = int(lens[order[s]])
        raw = t_seqs[:n, order[s]]
        want = np.where((raw >= 0) & (raw < A), raw, A)
        np.testing.assert_array_equal(seqs[off[s]:off[s] + n], want)
        pad = -n % sw_packed.T_ALIGN
        assert np.all(seqs[off[s] + n:off[s] + n + pad] == A + 1)

    got = sw_pallas.sw_scores_packed(args[0], args[1], packed, go, ge)
    np.testing.assert_array_equal(
        got.numpy(), sw_pallas.sw_scores_batch_plain(*args, go, ge).numpy())
    np.testing.assert_array_equal(
        got.numpy(), _jax_batch(prof, q_len, t_seqs, t_len, go, ge))


@pytest.mark.parametrize("case", ["pallas_one_query", "ragged_a21_gap10_1"])
def test_one_query_plain_matches_pallas(case):
    """B3 on each of the first queries (the empty one and the one past a
    stripe among them) against sw_scores_one_query_pallas; T is padded
    to the Pallas 256-target tile on the JAX side only."""
    from spacepharer_tpu.ops.sw_pallas import sw_scores_one_query_pallas
    prof, q_len, t_seqs, t_len, go, ge = CASES[case]()
    T = t_seqs.shape[1]
    Tp = -(-T // 256) * 256
    ts = np.full((t_seqs.shape[0], Tp), 20, np.int32)
    ts[:, :T] = t_seqs
    tl = np.zeros((1, Tp), np.int32)
    tl[:, :T] = t_len
    for qi in range(min(6, prof.shape[0])):
        ref = np.asarray(sw_scores_one_query_pallas(
            prof[qi], q_len[qi].reshape(1, 1), ts, tl, gap_open=go,
            gap_extend=ge, interpret=True))[:T]
        got = sw_pallas.sw_scores_one_query(
            *_torch(prof[qi], q_len[qi], t_seqs, t_len), go, ge).numpy()
        assert got.shape == (T,)
        np.testing.assert_array_equal(got, ref)


def test_plain_runs_match_one_run(monkeypatch):
    """Target runs of the plain version (each scanned to its own longest
    target) give the one-run scores."""
    prof, q_len, t_seqs, t_len, go, ge = CASES["ragged_a32"]()
    args = _torch(prof, q_len, t_seqs, t_len)
    whole = sw_pallas.sw_scores_batch_plain(*args, go, ge)
    monkeypatch.setattr(sw_pallas, "PLAIN_MAX_ELEMS", 1)
    np.testing.assert_array_equal(
        sw_pallas.sw_scores_batch_plain(*args, go, ge).numpy(),
        whole.numpy())


def test_wrappers_take_cpu_only_as_plain():
    """CPU tensors run the plain version and launch nothing; other
    devices are refused."""
    prof, q_len, t_seqs, t_len, go, ge = CASES["pallas_one_query"]()
    names = ("sw_dense_batch_launches", "sw_dense_one_query_launches",
             "sw_dense_cells")
    before = _counted(*names)
    sw_pallas.sw_scores_batch(*_torch(prof, q_len, t_seqs, t_len), go, ge)
    assert _counted(*names) == before
    with pytest.raises(ValueError, match="unsupported device"):
        sw_pallas.sw_scores_batch(
            *(x.to("meta") for x in _torch(prof, q_len, t_seqs, t_len)))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_batch_matches_plain(case):
    dev = _cuda()
    prof, q_len, t_seqs, t_len, go, ge = cuda_case(case)
    args = tuple(x.to(dev) for x in _torch(prof, q_len, t_seqs, t_len))
    (before,) = _counted("sw_dense_batch_launches")
    got = sw_pallas.sw_scores_batch(*args, go, ge)
    assert _counted("sw_dense_batch_launches")[0] > before
    ref = sw_pallas.sw_scores_batch_plain(*args, go, ge)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_one_query_matches_plain(case):
    dev = _cuda()
    prof, q_len, t_seqs, t_len, go, ge = cuda_case(case)
    ts, tl = (x.to(dev) for x in _torch(t_seqs, t_len))
    for qi in range(min(6, prof.shape[0])):
        p, ql = (x.to(dev) for x in _torch(prof[qi], q_len[qi]))
        (before,) = _counted("sw_dense_one_query_launches")
        got = sw_pallas.sw_scores_one_query(p, ql, ts, tl, go, ge)
        assert _counted("sw_dense_one_query_launches")[0] == before + 1
        ref = sw_pallas.sw_scores_one_query_plain(p, ql, ts, tl, go, ge)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), qi


@pytest.mark.cuda
def test_cuda_split_launches_match_plain(monkeypatch):
    """A scratch budget of one slot per launch gives one launch per query
    past one stripe (2300, 40 and 17 rows): query, slot and output
    offsets per launch."""
    dev = _cuda()
    prof, q_len, t_seqs, t_len, go, ge = cuda_case("long_query")
    args = tuple(x.to(dev) for x in _torch(prof, q_len, t_seqs, t_len))
    monkeypatch.setattr(sw_pallas, "SCRATCH_BYTES", 1)
    (before,) = _counted("sw_dense_batch_launches")
    got = sw_pallas.sw_scores_batch(*args, go, ge)
    assert _counted("sw_dense_batch_launches")[0] - before == 3
    ref = sw_pallas.sw_scores_batch_plain(*args, go, ge)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
