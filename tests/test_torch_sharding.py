"""The port's device mesh (parallel/sharding.py) against the JAX
package's, on the 8 virtual CPU devices of tests/conftest.py for JAX and
8 shards on the CPU for the port. Scores are integers: every comparison
is exact, top-k indices included."""
import jax
import numpy as np
import pytest
import torch

from spacepharer_tpu.parallel import sharding as jax_sh
from spacepharer_tpu.parallel.distributed import (
    shard_indices as jax_shard_indices)
from spacepharer_tpu_torch import graft_entry
from spacepharer_tpu_torch.ops.matrices import load_matrix
from spacepharer_tpu_torch.parallel import sharding
from spacepharer_tpu_torch.parallel.distributed import shard_indices

MESHES = [(1, 8), (2, 4), (4, 2)]


@pytest.fixture(scope="module", autouse=True)
def _eight_jax_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 JAX devices (tests/conftest.py)")


def _matrix():
    return load_matrix("VTML40.out", 2.0)


def _step_workload():
    """tests/test_sharded_search.py's workload."""
    rng = np.random.default_rng(17)
    m = _matrix()
    qs = [rng.integers(0, 20, rng.integers(6, 16)) for _ in range(8)]
    ts = [rng.integers(0, 20, rng.integers(20, 60)) for _ in range(16)]
    q_prof, q_len = sharding.pack_queries(qs, m.scores, 16)
    t_seqs, t_len = sharding.pack_targets(ts, 64, x_index=20)
    return q_prof, q_len, t_seqs, t_len


def _pipeline_workload():
    """24 queries (one empty, one past a 16-row stripe; query sets of 5
    straddle the q splits at 6, 12 and 18) x 32 targets (three duplicates
    that tie with their originals; target sets 8 and 9 of 10 hold no
    target)."""
    rng = np.random.default_rng(5)
    m = _matrix()
    qs = [rng.integers(0, 20, int(rng.integers(5, 14))) for _ in range(22)]
    qs = qs[:3] + [np.zeros(0, np.int64), rng.integers(0, 20, 30)] + qs[3:]
    qs = qs[:24]
    ts = [rng.integers(0, 21, int(rng.integers(8, 70))) for _ in range(29)]
    ts = ts[:5] + [ts[2].copy()] + ts[5:17] + [ts[2].copy(), ts[9].copy()] \
        + ts[17:]
    ts = ts[:32]
    set_of_t = (np.arange(32) % 9).astype(np.int32)
    set_of_t[set_of_t == 8] = 0
    q_prof, q_len = sharding.pack_queries(qs, m.scores, 32)
    t_seqs, t_len = sharding.pack_targets(ts, 72, x_index=20)
    set_of_q = (np.arange(24) // 5).astype(np.int32)
    return qs, ts, set_of_t, (q_prof, q_len, t_seqs, t_len), set_of_q


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_search_step_matches_jax(shape):
    args = _step_workload()
    ref_sc, ref_idx = jax_sh.sharded_search_step(
        jax_sh.make_mesh(*shape), top_k=5)(*args)
    got_sc, got_idx = sharding.sharded_search_step(
        sharding.make_mesh(*shape, devices=["cpu"]), top_k=5)(*args)
    np.testing.assert_array_equal(got_sc, np.asarray(ref_sc))
    np.testing.assert_array_equal(got_idx, np.asarray(ref_idx))


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_search_pipeline_matches_jax(shape):
    _, _, set_of_t, args, set_of_q = _pipeline_workload()
    n_sets, n_qsets = 10, 5
    ref = jax_sh.sharded_search_pipeline(
        jax_sh.make_mesh(*shape), top_k=4, n_sets=n_sets,
        n_qsets=n_qsets)(*args, set_of_t, set_of_q)
    got = sharding.sharded_search_pipeline(
        sharding.make_mesh(*shape, devices=["cpu"]), top_k=4,
        n_sets=n_sets, n_qsets=n_qsets)(*args, set_of_t, set_of_q)
    assert len(got) == 4
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(r))
    assert not got[2][:, 8:].any()          # sets 8 and 9 hold no target


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_search_pipeline_oracle(shape):
    """The dry run's oracle (exact host forward pass, lexsort tie rule,
    best-set and query-set sums) on the tie / empty-set workload."""
    qs, ts, set_of_t, _, _ = _pipeline_workload()
    graft_entry._run_mesh_variant(*shape, qs, ts, set_of_t, 10,
                                  devices=["cpu"])


def test_pipeline_without_query_sets():
    _, _, set_of_t, args, _ = _pipeline_workload()
    mesh = sharding.make_mesh(2, 4, devices=["cpu"])
    sc, idx, best = sharding.sharded_search_pipeline(
        mesh, top_k=3, n_sets=10)(*args, set_of_t)
    ref = jax_sh.sharded_search_pipeline(
        jax_sh.make_mesh(2, 4), top_k=3, n_sets=10)(*args, set_of_t)
    for g, r in zip((sc, idx, best), ref):
        np.testing.assert_array_equal(g, np.asarray(r))


@pytest.mark.parametrize("gaps", [(16, 2), (10, 1)])
def test_sw_score_allpairs_matches_jax(gaps):
    """The per-shard scorer in the JAX [T, LT] target layout, with an
    empty query and an empty target."""
    import torch
    q_prof, q_len, t_seqs, t_len = _step_workload()
    q_len[2], t_len[5] = 0, 0
    ref = jax_sh.sw_score_allpairs(q_prof, q_len, t_seqs, t_len, *gaps)
    got = sharding.sw_score_allpairs(
        *(torch.from_numpy(x) for x in (q_prof, q_len, t_seqs, t_len)),
        *gaps)
    assert got.dtype == torch.int32 and tuple(got.shape) == (8, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not got[2].any() and not got[:, 5].any()


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_allpairs_scores_matches_jax(shape):
    """Ragged sides (padding to the mesh), per-row bias, one query alone
    on a q shard."""
    rng = np.random.default_rng(3)
    m = _matrix()
    qs = [rng.integers(0, 21, int(rng.integers(1, 25))) for _ in range(5)]
    ts = [rng.integers(0, 21, int(rng.integers(1, 90))) for _ in range(19)]
    biases = [rng.integers(-3, 4, len(q)) for q in qs]
    ref = jax_sh.sharded_allpairs_scores(jax_sh.make_mesh(*shape), qs, ts,
                                         m.scores, bias_list=biases)
    got = sharding.sharded_allpairs_scores(
        sharding.make_mesh(*shape, devices=["cpu"]), qs, ts, m.scores,
        bias_list=biases)
    assert got.dtype == np.int32 and got.shape == (5, 19)
    np.testing.assert_array_equal(got, ref)


def test_make_mesh_without_a_card_raises(monkeypatch):
    """The mesh's default devices are the cards; without one it raises
    instead of sitting on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        sharding.make_mesh(2, 4)
    assert sharding.make_mesh(2, 4, devices=["cpu"]).shape == (2, 4)


def test_make_mesh_places_shards_round_robin():
    mesh = sharding.make_mesh(2, 4, devices=["cpu", "meta", "cpu"])
    assert mesh.shape == (2, 4)
    assert [str(mesh.device(i, j)) for i in range(2) for j in range(4)] == \
        ["cpu", "meta", "cpu", "cpu", "meta", "cpu", "cpu", "meta"]
    assert sharding.make_mesh(2, devices=["cpu"] * 8).shape == (2, 4)


def test_topk_tie_rule():
    import torch
    scores = torch.tensor([[3, 7, 7, 1, 7], [0, 0, 0, 0, 0]],
                          dtype=torch.int32)
    sc, idx = sharding.topk_desc(scores, 4)
    assert sc.tolist() == [[7, 7, 7, 3], [0, 0, 0, 0]]
    assert idx.tolist() == [[1, 2, 4, 0], [0, 1, 2, 3]]


def test_shard_indices_partition():
    for n, s in [(691, 8), (10, 3), (8, 8), (5, 7)]:
        got = np.concatenate([shard_indices(n, s, i) for i in range(s)])
        assert np.array_equal(got, np.arange(n))
        for i in range(s):
            assert np.array_equal(shard_indices(n, s, i),
                                  jax_shard_indices(n, s, i))
