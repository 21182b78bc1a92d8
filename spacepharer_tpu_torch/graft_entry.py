"""Entry points of the port: the single-device scoring step
and a multi-shard dry run (the analogs of the repo's __graft_entry__.py).

Both run on the card and raise without one, unless the caller names the
CPU (device="cpu", devices=["cpu"]).
"""
import numpy as np


def entry(device=None):
    """The batched Smith-Waterman scoring step over (query, target) pairs
    (ops/sw_tpu.py) and its inputs, on `device` (default: the first
    card, raising without one): returns (fn, args)."""
    from .ops.matrices import load_matrix
    from .ops.sw_tpu import build_sub_batch, sw_score_batch
    from .parallel.sharding import default_devices

    rng = np.random.default_rng(0)
    m = load_matrix("VTML40.out", 2.0)
    qs = [rng.integers(0, 20, 16) for _ in range(8)]
    ts = [rng.integers(0, 20, 64) for _ in range(8)]
    args = build_sub_batch(qs, ts, m.scores,
                           device=device or default_devices()[0])

    def fn(sub, q_len, t_len):
        return sw_score_batch(sub, q_len, t_len, 16, 2)

    return fn, args


def mesh_inputs(qs, ts, set_of_t, n_q: int, n_t: int) -> dict:
    """The pipeline's inputs for an (n_q, n_t) mesh: both sides padded
    with empty sequences to the mesh, packed, and the query-set map (sets
    of 3 rows, so that sets straddle q-shard boundaries)."""
    from .parallel.sharding import pack_queries, pack_targets
    from .ops.matrices import load_matrix

    m = load_matrix("VTML40.out", 2.0)
    qs = list(qs)
    ts = list(ts)
    Q = -(-len(qs) // n_q) * n_q
    T = -(-len(ts) // n_t) * n_t
    qs += [np.zeros(0, np.int64)] * (Q - len(qs))
    ts += [np.zeros(0, np.int64)] * (T - len(ts))
    lq = max(8, ((max(len(q) for q in qs) + 7) // 8) * 8)
    lt = max(8, ((max(len(t) for t in ts) + 7) // 8) * 8)
    q_prof, q_len = pack_queries(qs, m.scores, lq)
    t_seqs, t_len = pack_targets(ts, lt, x_index=20)
    set_of_q = np.arange(Q, dtype=np.int32) // 3
    return dict(qs=qs, ts=ts, q_prof=q_prof, q_len=q_len, t_seqs=t_seqs,
                t_len=t_len, set_of_q=set_of_q, n_qsets=int(set_of_q[-1]) + 1,
                set_of_t=np.concatenate(
                    [set_of_t, np.zeros(T - len(set_of_t), np.int32)]
                ).astype(np.int32))


def check_mesh_result(inputs: dict, n_sets: int, result, top_k: int,
                      oracle=None, label=()):
    """Assert a pipeline result (top scores, top ids, best per set, query
    set sums) against the exact host forward pass over all targets: the
    top-k SCORES, the top-k INDICES under the global tie rule (equal
    scores resolve to the lower global target id), the best-hit-per-
    target-set table and the query-set sums. `oracle` memoises the
    forward pass per query row across calls."""
    from .ops.align import _forward_pass
    from .ops.matrices import load_matrix

    m = load_matrix("VTML40.out", 2.0)
    qs, ts, set_of_t = inputs["qs"], inputs["ts"], inputs["set_of_t"]
    Q, T = len(qs), len(ts)
    scores, idx, best_set, comb = result
    n_qsets = inputs["n_qsets"]
    assert scores.shape == (Q, top_k) and idx.shape == (Q, top_k)
    assert best_set.shape == (Q, n_sets)
    assert comb.shape == (n_qsets, n_sets)
    want_comb = np.zeros((n_qsets, n_sets), dtype=np.int64)
    np.add.at(want_comb, inputs["set_of_q"], best_set.astype(np.int64))
    assert np.array_equal(comb.astype(np.int64), want_comb), \
        (label, "combinescore aggregation mismatch")

    oracle = {} if oracle is None else oracle
    rows = [qi for qi in range(0, Q, max(1, Q // 6)) if len(qs[qi])]
    for qi in rows:
        key = (qi, T)
        if key not in oracle:
            prof = m.scores[np.asarray(qs[qi], dtype=np.int64)].astype(
                np.int64)
            oracle[key] = np.array(
                [_forward_pass(prof[:, np.asarray(t, dtype=np.int64)].T,
                               16, 2)[0] if len(t) else 0
                 for t in ts], dtype=np.int64)
        all_scores = oracle[key]
        want_idx = np.lexsort((np.arange(T), -all_scores))[:top_k]
        assert np.array_equal(idx[qi], want_idx), \
            (label, qi, idx[qi].tolist(), want_idx.tolist())
        assert np.array_equal(scores[qi], all_scores[want_idx]), (label, qi)
        want = np.zeros(n_sets, dtype=np.int64)
        np.maximum.at(want, set_of_t, all_scores)
        assert np.array_equal(np.maximum(want, 0), best_set[qi]), \
            (label, qi)


def _run_mesh_variant(n_q, n_t, qs, ts, set_of_t, n_sets, devices=None,
                      oracle=None, top_k=4):
    """One sharded search step over an (n_q, n_t) mesh, checked by
    check_mesh_result."""
    from .parallel.sharding import make_mesh, sharded_search_pipeline

    inp = mesh_inputs(qs, ts, set_of_t, n_q, n_t)
    step = sharded_search_pipeline(make_mesh(n_q, n_t, devices),
                                   top_k=top_k, n_sets=n_sets,
                                   n_qsets=inp["n_qsets"])
    result = step(inp["q_prof"], inp["q_len"], inp["t_seqs"], inp["t_len"],
                  inp["set_of_t"], inp["set_of_q"])
    check_mesh_result(inp, n_sets, result, top_k, oracle, (n_q, n_t))


def golden_slice(n_devices: int, query_db, target_db):
    """The dry run's corpus slice: the first 8n query ORFs of `query_db`
    and 16n ORFs of `target_db` (its longest half, full length, plus the
    head of the rest), numeric; the target ORFs' set ids and the number
    of target sets. The DBs are SetDBs or their paths."""
    from .alphabet import encode_aa
    from .io.setdb import SetDB

    qdb = SetDB.load(query_db) if isinstance(query_db, str) else query_db
    tdb = SetDB.load(target_db) if isinstance(target_db, str) else target_db
    qs = [encode_aa(qdb.orf_aa(i).tobytes())
          for i in range(min(qdb.n_orfs, 8 * n_devices))]
    n_targets = min(tdb.n_orfs, 16 * n_devices)
    t_lens = np.diff(np.asarray(tdb.orf_aa_offsets))
    longest = np.argsort(-t_lens, kind="stable")[:n_targets // 2]
    longest_set = set(longest.tolist())
    head = [i for i in range(tdb.n_orfs) if i not in longest_set]
    t_idx = sorted(longest.tolist() + head[:n_targets - len(longest)])
    ts = [encode_aa(tdb.orf_aa(i).tobytes()) for i in t_idx]
    assert max(len(t) for t in ts) > 256, "long-ORF coverage lost"
    return (qs, ts, np.asarray(tdb.orf_to_set[t_idx], dtype=np.int32),
            int(tdb.set_size.shape[0]))


def dryrun_multichip(n_devices: int, query_db, target_db,
                     devices=None) -> list:
    """The sharded search pipeline over an n-shard mesh on a real corpus
    slice (golden_slice): query blocks on the q axis, the target ORFs and
    their set map on the t axis, per-shard SW (kernel B4), the top-k
    merge over t, best-hit-per-target-set and the query-set sum. Runs
    both mesh orientations when n allows ((2,4) and (4,2) at 8) and
    checks each against the exact host forward pass. Shards sit on
    `devices` (default: the cards, raising without one). Returns the mesh
    shapes run."""
    qs, ts, set_of_t, n_sets = golden_slice(n_devices, query_db, target_db)
    n_q = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    shapes = [(n_q, n_devices // n_q)]
    if n_devices % 4 == 0 and n_devices >= 8:
        shapes.append((4, n_devices // 4))
    oracle = {}
    for nq_sh, nt_sh in shapes:
        _run_mesh_variant(nq_sh, nt_sh, qs, ts, set_of_t, n_sets, devices,
                          oracle)
    return shapes
