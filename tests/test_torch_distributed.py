"""The port's multi-process mesh (parallel/distributed.py) with gloo on
the CPU: 4 spawned processes, one (q, t) shard each, meshes (2, 2) and
(1, 4), against the JAX package's sharded_search_pipeline on the same
inputs and against the port's single-process pipeline. The workers
import the port only, never jax; rendezvous goes through a file, and a
hung worker fails the test at its time limit."""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from spacepharer_tpu.parallel import sharding as jax_sh
from spacepharer_tpu_torch.ops.align import _forward_pass
from spacepharer_tpu_torch.ops.matrices import load_matrix
from spacepharer_tpu_torch.parallel import sharding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [(2, 2), (1, 4)]
WORLD = 4
TOP_K, N_SETS, N_QSETS = 4, 7, 6

WORKER = textwrap.dedent(r"""
    import sys
    import numpy as np
    import torch.distributed as dist
    from spacepharer_tpu_torch.parallel.distributed import (
        distributed_search_pipeline, initialize)

    init, rank, inputs, out = (sys.argv[1], int(sys.argv[2]), sys.argv[3],
                               sys.argv[4])
    rank, world = initialize(init_method=init, world_size=4, rank=rank,
                             backend="gloo", timeout_s=60)
    d = np.load(inputs)
    res = {}
    for n_q, n_t in ((2, 2), (1, 4)):
        i, j = divmod(rank, n_t)
        ql, tl = len(d["q_prof"]) // n_q, len(d["t_seqs"]) // n_t
        qs, ts = slice(i * ql, (i + 1) * ql), slice(j * tl, (j + 1) * tl)
        step = distributed_search_pipeline(n_q, n_t, top_k=%(top_k)d,
                                           n_sets=%(n_sets)d,
                                           n_qsets=%(n_qsets)d)
        got = step(d["q_prof"][qs], d["q_len"][qs], d["t_seqs"][ts],
                   d["t_len"][ts], d["set_of_t"][ts], d["set_of_q"][qs])
        for name, x in zip(("sc", "idx", "best", "comb"), got):
            res[f"{n_q}x{n_t}_{name}"] = x
    dist.destroy_process_group()
    res["jax_imported"] = np.array(
        any(m.split(".")[0] in ("jax", "spacepharer_tpu")
            for m in sys.modules))
    np.savez(out, **res)
""") % dict(top_k=TOP_K, n_sets=N_SETS, n_qsets=N_QSETS)


def _workload():
    """16 queries (one empty, one past a 16-row stripe; query sets of 3
    straddle the q split) x 24 targets (two duplicates that tie; target
    sets 5 and 6 hold no target)."""
    rng = np.random.default_rng(21)
    m = load_matrix("VTML40.out", 2.0)
    qs = [rng.integers(0, 20, int(rng.integers(4, 14))) for _ in range(14)]
    qs = qs[:2] + [np.zeros(0, np.int64), rng.integers(0, 20, 25)] + qs[2:]
    ts = [rng.integers(0, 21, int(rng.integers(6, 60))) for _ in range(22)]
    ts = ts[:4] + [ts[1].copy()] + ts[4:15] + [ts[1].copy()] + ts[15:]
    q_prof, q_len = sharding.pack_queries(qs, m.scores, 32)
    t_seqs, t_len = sharding.pack_targets(ts, 64, x_index=20)
    return dict(q_prof=q_prof, q_len=q_len, t_seqs=t_seqs, t_len=t_len,
                set_of_t=(np.arange(24) % 5).astype(np.int32),
                set_of_q=(np.arange(16) // 3).astype(np.int32))


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """Spawn the 4 workers once; returns (inputs, per-rank results)."""
    tmp = tmp_path_factory.mktemp("gloo")
    data = _workload()
    np.savez(tmp / "inputs.npz", **data)
    script = tmp / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=REPO, GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), f"file://{tmp / 'rendezvous'}",
         str(r), str(tmp / "inputs.npz"), str(tmp / f"out{r}.npz")],
        env=env, cwd=str(tmp), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(WORLD)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            errs.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (rc, err) in enumerate(errs):
        assert rc == 0, (r, err[-3000:])
    return data, [dict(np.load(tmp / f"out{r}.npz")) for r in range(WORLD)]


def _assemble(results, n_q, n_t):
    """The query blocks' results from the ranks with t index 0, stacked;
    every rank's query-set sums; and each rank's merged top scores beside
    those of its block's t-0 rank."""
    key = f"{n_q}x{n_t}_"
    rows = [results[i * n_t] for i in range(n_q)]
    return ([np.concatenate([r[key + name] for r in rows])
             for name in ("sc", "idx", "best")],
            [r[key + "comb"] for r in results],
            [(results[i * n_t + j][key + "sc"], rows[i][key + "sc"])
             for i in range(n_q) for j in range(n_t)])


@pytest.mark.parametrize("shape", MESHES)
def test_gloo_pipeline_matches_jax(gloo_run, shape):
    data, results = gloo_run
    assert not any(bool(r["jax_imported"]) for r in results)
    (sc, idx, best), combs, replicas = _assemble(results, *shape)
    args = [data[k] for k in ("q_prof", "q_len", "t_seqs", "t_len",
                              "set_of_t", "set_of_q")]
    ref = jax_sh.sharded_search_pipeline(
        jax_sh.make_mesh(*shape, devices=jax.devices()[:WORLD]),
        top_k=TOP_K, n_sets=N_SETS, n_qsets=N_QSETS)(*args)
    local = sharding.sharded_search_pipeline(
        sharding.make_mesh(*shape, devices=["cpu"]), top_k=TOP_K,
        n_sets=N_SETS, n_qsets=N_QSETS)(*args)
    for got, want, mine in zip((sc, idx, best, combs[0]), ref, local):
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(got, mine)
    for comb in combs:                       # replicated on every rank
        np.testing.assert_array_equal(comb, combs[0])
    for a, b in replicas:                    # every t shard holds the merge
        np.testing.assert_array_equal(a, b)
    assert not best[:, 5:].any()
    # the exact host forward pass over all targets, (score desc, index asc)
    for qi in (0, 3, 9, 15):
        n = int(data["q_len"][qi])
        prof = data["q_prof"][qi, :n].astype(np.int64)
        full = np.array([_forward_pass(prof[:, t[:k]].T, 16, 2)[0] if k
                         else 0 for t, k in zip(data["t_seqs"],
                                                data["t_len"])])
        want = np.lexsort((np.arange(len(full)), -full))[:TOP_K]
        np.testing.assert_array_equal(idx[qi], want)
        np.testing.assert_array_equal(sc[qi], full[want])
        per_set = np.zeros(N_SETS, np.int64)
        np.maximum.at(per_set, data["set_of_t"], full)
        np.testing.assert_array_equal(best[qi], per_set)
