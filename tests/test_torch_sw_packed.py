"""The port's all-pairs SW scorer (ops/sw_packed.py) against the JAX
package's packed Pallas kernel, run in interpret mode on the CPU.

Scores are integers, so every comparison is exact. The CPU cases run
the kernel's plain PyTorch version; the `cuda` case holds the CUDA
kernel against that plain version on the card. JAX is imported only
where the JAX side runs, so the `cuda` case also runs where JAX is not
installed (`pytest -m cuda tests/test_torch_sw_packed.py` on a GPU box).
"""
import numpy as np
import pytest
import torch

from spacepharer_tpu_torch.logging import timings
from spacepharer_tpu_torch.ops import sw_packed
from spacepharer_tpu_torch.ops.matrices import load_matrix


def _counted(*names):
    """The registry's totals (logging.timings) of the named counters."""
    got = timings()
    return tuple(got.get(n, 0) for n in names)


def _case_random(seed):
    rng = np.random.default_rng(seed)
    qs = [rng.integers(0, 20, int(rng.integers(3, 25))) for _ in range(9)]
    ts = [rng.integers(0, 20, int(rng.integers(5, 90))) for _ in range(23)]
    biases = [rng.integers(-3, 4, len(q)) for q in qs]
    return qs, ts, biases, 16, 2, {}


def _case_multiblock():
    rng = np.random.default_rng(11)
    qs = [rng.integers(0, 20, int(rng.integers(3, 20))) for _ in range(14)]
    ts = [rng.integers(0, 20, int(rng.integers(5, 70))) for _ in range(9)]
    return qs, ts, None, 16, 2, dict(t_tile=8, sq_block=64, seg_len=8,
                                     depth_cap=64)


def _case_big_query():
    """A query whose score bound reaches the TPU kernel's BIG = 4096
    (the JAX side routes it to its bucketed scan; the port's kernel
    scores it directly)."""
    rng = np.random.default_rng(3)
    m = load_matrix("VTML40.out", 2.0)
    self_max_letter = int(np.argmax(np.diag(m.scores[:20, :20])))
    big_q = np.full(400, self_max_letter, dtype=np.int64)
    small_qs = [rng.integers(0, 20, int(rng.integers(5, 20)))
                for _ in range(4)]
    qs = small_qs[:2] + [big_q] + small_qs[2:]
    ts = [rng.integers(0, 20, int(rng.integers(10, 80)))
          for _ in range(7)] + [big_q[:300].copy()]
    return qs, ts, None, 16, 2, None


def _case_x_gaps():
    rng = np.random.default_rng(7)
    qs = [rng.integers(0, 21, int(rng.integers(4, 20))) for _ in range(5)]
    ts = [rng.integers(0, 21, int(rng.integers(8, 60))) for _ in range(17)]
    return qs, ts, None, 10, 1, {}


CASES = {
    "seed0": lambda: _case_random(0),
    "seed1": lambda: _case_random(1),
    "seed2": lambda: _case_random(2),
    "multiblock": _case_multiblock,
    "big_query": _case_big_query,
    "x_gap10_1": _case_x_gaps,
}


def _jax_scores(qs, ts, biases, go, ge, pack_kw):
    """The JAX package's packed kernel (interpret mode); pack_kw=None
    goes through device_allpairs_scores and its wide-query routing."""
    from spacepharer_tpu.ops import sw_packed as jax_sw
    m = load_matrix("VTML40.out", 2.0)
    if pack_kw is None:
        return jax_sw.device_allpairs_scores(
            qs, ts, m.scores, bias_list=biases, gap_open=go, gap_extend=ge,
            interpret=True)
    pack = jax_sw.pack_query_rows(qs, m.scores, bias_list=biases,
                                  gap_open=go, gap_extend=ge,
                                  sq_block=pack_kw.get("sq_block"))
    tpack = jax_sw.pack_targets_segmented(
        ts, **{k: v for k, v in pack_kw.items() if k != "sq_block"})
    return np.asarray(jax_sw.allpairs_scores(pack, tpack, gap_open=go,
                                             gap_extend=ge, interpret=True))


@pytest.mark.parametrize("case", list(CASES))
def test_device_allpairs_scores_matches_jax(case):
    qs, ts, biases, go, ge, pack_kw = CASES[case]()
    m = load_matrix("VTML40.out", 2.0)
    ref = _jax_scores(qs, ts, biases, go, ge, pack_kw)
    got = sw_packed.device_allpairs_scores(
        qs, ts, m.scores, bias_list=biases, gap_open=go, gap_extend=ge,
        device="cpu")
    assert got.dtype == np.int32 and got.shape == (len(qs), len(ts))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", list(CASES))
def test_allpairs_scores_matches_jax(case):
    """The explicit pack -> allpairs_scores route, with empty sequences
    added on both sides (they score 0, as in the JAX packer)."""
    qs, ts, biases, go, ge, pack_kw = CASES[case]()
    m = load_matrix("VTML40.out", 2.0)
    ref = _jax_scores(qs, ts, biases, go, ge, pack_kw)
    empty = np.zeros(0, dtype=np.int64)
    qs2 = [empty] + qs
    ts2 = ts + [empty]
    b2 = None if biases is None else [empty] + biases
    got = sw_packed.allpairs_scores(
        sw_packed.pack_queries(qs2, m.scores, b2),
        sw_packed.pack_targets(ts2), gap_open=go, gap_extend=ge,
        device="cpu")
    assert not got[0].any() and not got[:, -1].any()
    np.testing.assert_array_equal(got[1:, :-1], ref)


def test_pack_targets_layout():
    """Longest first, 16-aligned starts, pad letter 31, order maps back."""
    ts = [np.array([1, 2, 3]), np.arange(20) % 21, np.zeros(0, np.int64),
          np.array([20] * 16)]
    tp = sw_packed.pack_targets(ts)
    assert tp["t_len"].tolist() == [20, 16, 3, 0]
    assert tp["order"].tolist() == [1, 3, 0, 2]
    assert all(o % sw_packed.T_ALIGN == 0 for o in tp["t_off"])
    for slot, ti in enumerate(tp["order"]):
        o, n = tp["t_off"][slot], tp["t_len"][slot]
        assert tp["t_seqs"][o:o + n].tolist() == list(ts[ti])
    assert (tp["t_seqs"][20:32] == sw_packed.PAD_LETTER).all()
    with pytest.raises(ValueError, match="letters"):
        sw_packed.pack_targets([np.array([0, 31])])


def _case_long_query():
    """Queries past one 16-row stripe and past 2048 rows, with a score
    far above 4096: the kernel's stripe-boundary scratch path."""
    rng = np.random.default_rng(13)
    m = load_matrix("VTML40.out", 2.0)
    top = int(np.argmax(np.diag(m.scores[:20, :20])))
    huge = np.full(2300, top, dtype=np.int64)
    qs = [huge, rng.integers(0, 21, 40), huge[:17], huge[:16]]
    ts = [huge[:1800].copy(), rng.integers(0, 21, 700),
          rng.integers(0, 21, 3)]
    return qs, ts, [rng.integers(-3, 4, len(q)) for q in qs], 16, 2, None


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES) + ["long_query"])
def test_cuda_kernel_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    make = _case_long_query if case == "long_query" else CASES[case]
    qs, ts, biases, go, ge, _ = make()
    m = load_matrix("VTML40.out", 2.0)
    (before,) = _counted("sw_allpairs_launches")
    got = sw_packed.device_allpairs_scores(qs, ts, m.scores, biases, go, ge,
                                           device="cuda")
    assert _counted("sw_allpairs_launches")[0] > before
    ref = sw_packed.device_allpairs_scores(qs, ts, m.scores, biases, go, ge,
                                           device="cpu")
    np.testing.assert_array_equal(got, ref)


@pytest.mark.cuda
def test_cuda_kernel_split_launches_match_plain(monkeypatch):
    """A scratch budget of one slot per launch splits the long_query case
    (three queries past one stripe, a short one between them) into one
    launch per long query: query, slot and output offsets per launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    qs, ts, biases, go, ge, _ = _case_long_query()
    qs = qs[:1] + qs[3:] + qs[1:3]             # 2300, 16, 40, 17 rows
    biases = biases[:1] + biases[3:] + biases[1:3]
    m = load_matrix("VTML40.out", 2.0)
    monkeypatch.setattr(sw_packed, "SCRATCH_BYTES", 1)
    (before,) = _counted("sw_allpairs_launches")
    got = sw_packed.device_allpairs_scores(qs, ts, m.scores, biases, go, ge,
                                           device="cuda")
    assert _counted("sw_allpairs_launches")[0] - before == 3
    ref = sw_packed.device_allpairs_scores(qs, ts, m.scores, biases, go, ge,
                                           device="cpu")
    np.testing.assert_array_equal(got, ref)
