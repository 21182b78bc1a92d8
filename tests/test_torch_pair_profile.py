"""The GPU scoring engine's query side (ops/sw_packed.py: pair_profile,
pair_profile_plain and pack_pair_queries with the expected-score table):
each residue's composition bias and the int8 stripe profile, built in one
pass, against the JAX package's sw_bias_i8 folded into the profile by
pack_pair_queries, on seeded numpy inputs.

The bias decides which pairs pass the E-value screen, so every comparison
is exact. The `cuda` cases hold csrc/pair_profile.cu against its plain
version on the card and skip without one; JAX is imported only where the
JAX side runs.
"""
import numpy as np
import pytest
import torch

from spacepharer_tpu_torch.logging import timings
from spacepharer_tpu_torch.ops import sw_packed
from spacepharer_tpu_torch.ops.bias import expected_score_tab, round_half_away
from spacepharer_tpu_torch.ops.matrices import load_matrix
from spacepharer_tpu_torch.pipeline import predictmatch as pm


def _counted(*names):
    """The registry's totals (logging.timings) of the named counters."""
    got = timings()
    return tuple(got.get(n, 0) for n in names)


MATRICES = ["VTML40.out", "VTML80.out", "blosum62.out"]


def _queries(seed, lens, x_share=0.05):
    """Seeded queries of the given lengths over the 20 amino acids, about
    x_share of their letters X (letter 20)."""
    rng = np.random.default_rng(seed)
    out = []
    for n in lens:
        q = rng.integers(0, 20, int(n))
        q[rng.random(int(n)) < x_share] = 20
        out.append(q.astype(np.uint8))
    return out


def _block_edges():
    """Queries whose stripes and 20-residue halos cross every boundary of
    the kernel's blocks of 8 stripes: hundreds of one-stripe queries,
    queries of 15, 16, 17, 32 and 33 residues, empty queries between
    them, and one query of 44 stripes."""
    rng = np.random.default_rng(12)
    lens = []
    for k in range(320):
        lens.append(int(rng.integers(1, 17)))
        if k % 7 == 3:
            lens.append(0)
        if k % 40 == 0:
            lens += [15, 16, 0, 17, 32, 0, 0, 33]
    lens.insert(170, 701)
    return _queries(4, lens)


CASES = {
    # spacer ORFs (9-45 residues) and one-residue queries
    "spacer_orfs": lambda: _queries(
        0, [1, 1] + list(np.random.default_rng(10).integers(9, 46, 80))),
    # every length around the 40-residue window, with an empty query
    "around_the_window": lambda: _queries(1, [38, 39, 40, 41, 42, 0, 20, 21]),
    # long ORFs (up to ~1,800 residues) beside short ones
    "long_orfs": lambda: _queries(2, [1794, 9, 613, 45, 1200, 17]),
    # X-rich queries
    "x_rich": lambda: _queries(3, [12, 33, 57, 9], x_share=0.5),
    # stripes and halos across the kernel's block boundaries
    "block_edges": _block_edges,
}


def _pack_args(qs, m, expected=None, comp_bias=True):
    """pair_profile's arguments for qs (CPU tensors)."""
    lens = np.array([len(q) for q in qs], dtype=np.int64)
    q_off = np.zeros(len(qs) + 1, dtype=np.int64)
    np.cumsum(lens, out=q_off[1:])
    n_str = (lens + sw_packed.STRIPE - 1) // sw_packed.STRIPE
    q_stripe = np.zeros(len(qs), dtype=np.int64)
    np.cumsum(n_str[:-1], out=q_stripe[1:])
    tab = expected_score_tab(m) if expected is None else expected
    return (torch.from_numpy(np.concatenate(qs).astype(np.uint8)),
            torch.from_numpy(q_off), torch.from_numpy(q_stripe),
            int(n_str.sum()),
            torch.from_numpy(np.ascontiguousarray(m.scores, np.int32)),
            torch.from_numpy(np.ascontiguousarray(tab, np.float64)),
            comp_bias)


@pytest.mark.parametrize("matrix", MATRICES)
@pytest.mark.parametrize("case", list(CASES))
def test_profile_bias_matches_jax_sw_bias_i8(case, matrix):
    """pack_pair_queries with the expected-score table (the profile and
    its bias in one pass) equals pack_pair_queries with the JAX package's
    sw_bias_i8 of each query, bit for bit."""
    from spacepharer_tpu.ops.align import sw_bias_i8 as jax_sw_bias_i8
    from spacepharer_tpu.ops.matrices import load_matrix as jax_load_matrix
    qs = CASES[case]()
    m = load_matrix(matrix, 2.0)
    jm = jax_load_matrix(matrix, 2.0)
    want = sw_packed.pack_pair_queries(
        qs, m.scores, [jax_sw_bias_i8(q.astype(np.int64), jm) for q in qs])
    got = sw_packed.pack_pair_queries(qs, m.scores,
                                      expected=expected_score_tab(m))
    for key in ("prof", "q_stripe", "q_len"):
        assert torch.equal(got[key], want[key]), key
    plain, in_range = sw_packed.pair_profile_plain(*_pack_args(qs, m))
    assert in_range and torch.equal(plain, want["prof"])


@pytest.mark.parametrize("matrix", MATRICES)
def test_profile_without_bias_is_the_matrix(matrix):
    """comp_bias off: the profile of zero biases."""
    qs = CASES["spacer_orfs"]()
    m = load_matrix(matrix, 2.0)
    want = sw_packed.pack_pair_queries(
        qs, m.scores, [np.zeros(len(q), np.int64) for q in qs])
    assert torch.equal(sw_packed.pack_pair_queries(qs, m.scores)["prof"],
                       want["prof"])
    assert torch.equal(sw_packed.pair_profile(
        *_pack_args(qs, m, comp_bias=False)), want["prof"])


def test_profile_bias_rounds_half_away_from_zero():
    """One-residue queries have an empty window, so their bias is
    round_half_away(expected[letter]): a table of values at and beside
    +-0.5, +-1.5, +-2.5 rounds as sw_bias_i8 rounds (x +- 0.5 in float
    first, as (int)(x + 0.5) in C)."""
    m = load_matrix("VTML40.out", 2.0)
    tab = np.zeros(m.scores.shape[1])
    vals = [0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 0.49999999999999994,
            -0.49999999999999994, 0.0, -0.0, 3.5000000000000004]
    tab[:len(vals)] = vals
    qs = [np.array([a], np.uint8) for a in range(len(tab))]
    prof, in_range = sw_packed.pair_profile_plain(*_pack_args(qs, m, tab))
    bias = prof[:, 0, 0].long().numpy() - m.scores[np.arange(len(tab)), 0]
    assert in_range
    np.testing.assert_array_equal(bias, round_half_away(tab))
    np.testing.assert_array_equal(bias[:len(vals)],
                                  [1, -1, 2, -2, 3, -3, 1, -1, 0, 0, 4])


def test_profile_range_and_alphabet_checks():
    m = load_matrix("VTML40.out", 2.0)
    with pytest.raises(ValueError, match="int8"):
        sw_packed.pack_pair_queries([np.array([0, 3])], m.scores * 20,
                                    expected=expected_score_tab(m) * 20)
    with pytest.raises(ValueError, match="alphabet"):
        sw_packed.pack_pair_queries([np.array([0, 21])], m.scores,
                                    expected=expected_score_tab(m))
    with pytest.raises(ValueError, match="not both"):
        sw_packed.pack_pair_queries([np.array([0])], m.scores,
                                    [np.zeros(1)], expected=np.zeros(21))


def test_device_pair_scores_with_the_table_equals_host_biases():
    """device_pair_scores building the bias with the profile scores
    every pair as with _query_bias_i8's biases handed in."""
    rng = np.random.default_rng(7)
    qs = CASES["spacer_orfs"]() + CASES["around_the_window"]()
    ts = [rng.integers(0, 21, int(n)).astype(np.uint8)
          for n in rng.integers(20, 300, 30)]
    t_off = np.zeros(len(ts) + 1, dtype=np.int64)
    np.cumsum([len(t) for t in ts], out=t_off[1:])
    t_flat = np.concatenate(ts)
    cand = [rng.integers(0, len(ts), int(rng.integers(0, 6))) for _ in qs]
    cand_off = np.zeros(len(qs) + 1, dtype=np.int64)
    np.cumsum([len(c) for c in cand], out=cand_off[1:])
    cand_t = np.concatenate(cand).astype(np.int64)
    m40 = load_matrix("VTML40.out", 2.0)
    want = sw_packed.device_pair_scores(
        qs, pm._query_bias_i8(qs, m40), t_flat, t_off, cand_t, cand_off,
        m40.scores, device="cpu")
    got = sw_packed.device_pair_scores(
        qs, None, t_flat, t_off, cand_t, cand_off, m40.scores,
        device="cpu", expected=expected_score_tab(m40))
    np.testing.assert_array_equal(got, want)
    assert len(cand_t) > 100


# ---------------------------------------------------------------- on a card

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("matrix", MATRICES)
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_profile_kernel_matches_plain(case, matrix):
    _cuda_or_skip()
    qs = CASES[case]()
    m = load_matrix(matrix, 2.0)
    for comp_bias in (True, False):
        args = _pack_args(qs, m, comp_bias=comp_bias)
        plain, _ = sw_packed.pair_profile_plain(*args)
        (before,) = _counted("pair_profile_launches")
        got = sw_packed.pair_profile(*[a.cuda() if torch.is_tensor(a) else a
                                       for a in args])
        assert _counted("pair_profile_launches")[0] == before + 1
        assert torch.equal(got.cpu(), plain)


@pytest.mark.cuda
def test_cuda_profile_kernel_rounds_and_checks_the_range():
    _cuda_or_skip()
    m = load_matrix("VTML40.out", 2.0)
    tab = np.linspace(-3.5, 3.5, m.scores.shape[1])
    tab[:4] = [0.5, -0.5, 0.49999999999999994, -2.5]
    qs = [np.array([a], np.uint8) for a in range(len(tab))] + \
        CASES["spacer_orfs"]()
    args = _pack_args(qs, m, tab)
    plain, _ = sw_packed.pair_profile_plain(*args)
    dev = [a.cuda() if torch.is_tensor(a) else a for a in args]
    assert torch.equal(sw_packed.pair_profile(*dev).cpu(), plain)
    dev[4] = dev[4] * 20
    with pytest.raises(ValueError, match="int8"):
        sw_packed.pair_profile(*dev)
    dev[4] = dev[4] // 20
    dev[0] = dev[0].clone()
    dev[0][-1] = m.scores.shape[1]
    with pytest.raises(ValueError, match="alphabet"):
        sw_packed.pair_profile(*dev)


@pytest.mark.cuda
def test_cuda_profile_kernel_writes_every_byte(monkeypatch):
    """The wrapper allocates the profile and the flag uninitialised and
    the kernel writes every byte: with every buffer that torch.empty
    hands out filled with 0x5A first, the profile still equals the plain
    version's."""
    _cuda_or_skip()
    m = load_matrix("VTML40.out", 2.0)
    args = _pack_args(CASES["block_edges"](), m)
    plain, _ = sw_packed.pair_profile_plain(*args)
    dev = [a.cuda() if torch.is_tensor(a) else a for a in args]
    empty = torch.empty
    handed = []

    def junk_empty(*a, **kw):
        out = empty(*a, **kw)
        out.view(torch.uint8).fill_(0x5A)
        handed.append(out.dtype)
        return out

    monkeypatch.setattr(torch, "empty", junk_empty)
    got = sw_packed.pair_profile(*dev)
    monkeypatch.undo()
    assert torch.int8 in handed
    assert torch.equal(got.cpu(), plain)
