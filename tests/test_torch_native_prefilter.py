"""The port's native batch prefilter (native/search_native.c and the
finalize in native/sw_native.c): repeated calls give the same hits, and
no worker leaves its per-thread finalize scratch behind.

prefilter_batch starts fresh worker threads on every call; each frees
its thread-local finalize scratch before it exits, and the library
counts the threads whose scratch is still allocated
(prefilter_finalize_live).
"""
import numpy as np
import pytest

from spacepharer_tpu_torch.native import get_lib
from spacepharer_tpu_torch.ops.bias import local_aa_bias_batch
from spacepharer_tpu_torch.ops.matrices import load_matrix
from spacepharer_tpu_torch.ops.prefilter import (PrefilterParams,
                                                 SimilarKmerEnumerator,
                                                 build_target_index,
                                                 prefilter_query,
                                                 prefilter_query_batch)


def _corpus(seed, n_q=40, n_t=30):
    """Targets from a skewed letter distribution and queries that are
    mutated target fragments, random, short or empty."""
    rng = np.random.default_rng(seed)
    probs = rng.dirichlet(np.ones(20) * 0.5)
    t_seqs = [rng.choice(20, size=int(rng.integers(20, 250)),
                         p=probs).astype(np.uint8) for _ in range(n_t)]
    q_seqs = []
    for i in range(n_q):
        L = int(rng.integers(8, 60)) if i % 9 else int(rng.integers(0, 7))
        t = t_seqs[int(rng.integers(0, n_t))]
        if i % 2 and len(t) >= L:
            s = int(rng.integers(0, len(t) - L + 1))
            q = t[s:s + L].copy()
            q[rng.integers(0, max(L, 1), size=L // 6)] = rng.integers(0, 20)
        else:
            q = rng.choice(20, size=L, p=probs).astype(np.uint8)
        q_seqs.append(q.astype(np.uint8))
    return q_seqs, t_seqs


def _hits(hit_lists):
    return [[(h.target, h.score, h.diagonal) for h in hl]
            for hl in hit_lists]


@pytest.fixture(scope="module")
def lib():
    lib = get_lib()
    if lib is None:
        pytest.skip("no C compiler: the native library cannot be built")
    return lib


@pytest.mark.parametrize("seed", [1, 2])
def test_repeated_batches_match_and_free_their_scratch(lib, seed):
    q_seqs, t_seqs = _corpus(seed)
    pp = PrefilterParams()
    index = build_target_index(t_seqs, pp)
    seed_m = load_matrix(pp.seed_matrix, 8.0)
    ung_m = load_matrix(pp.ungapped_matrix, 2.0)
    lib.prefilter_finalize_release()        # this thread's, from earlier
    assert lib.prefilter_finalize_live() == 0
    runs = [_hits(prefilter_query_batch(q_seqs, index, pp, seed_m, ung_m))
            for _ in range(3)]
    assert lib.prefilter_finalize_live() == 0
    assert runs[0] == runs[1] == runs[2]
    assert sum(map(len, runs[0])) > 0
    enum = SimilarKmerEnumerator(seed_m.scores)
    bias = local_aa_bias_batch(q_seqs, seed_m)
    assert runs[0] == _hits(prefilter_query(
        q, index, pp, seed_m=seed_m, ungapped_m=ung_m, enumerator=enum,
        bias80=bias[i]) for i, q in enumerate(q_seqs))


def test_direct_finalize_scratch_is_released(lib):
    """The per-query path calls the finalize on this thread: its scratch
    stays for the next call until the thread releases it."""
    q_seqs, t_seqs = _corpus(3, n_q=6)
    pp = PrefilterParams()
    index = build_target_index(t_seqs, pp)
    lib.prefilter_finalize_release()
    hits = [prefilter_query(q, index, pp) for q in q_seqs]
    assert sum(map(len, hits)) > 0
    assert lib.prefilter_finalize_live() == 1
    lib.prefilter_finalize_release()
    lib.prefilter_finalize_release()        # a second release is a no-op
    assert lib.prefilter_finalize_live() == 0
