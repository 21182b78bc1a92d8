"""Device-mesh sharding of the search step (`--shards Q,T`).

The port of spacepharer_tpu/parallel/sharding.py. The reference splits
its work by target-DB splits (Prefiltering.cpp:709-740) and query splits
(MPI ranks); here the target ORFs shard over the mesh's ``t`` axis and
the query rows over its ``q`` axis, every shard scores its (query block x
target block) rectangle with kernel B4 (ops/sw_pallas.py, on the target
block packed once per device), and the
per-split merge (Prefiltering::mergeTargetSplits) is a top-k over the
gathered shard top-k lists.

A Mesh is a (q, t) grid of torch devices in this process, and its shards
run one after the other. Shard (i, j) sits on devices[(i * n_t + j) %
len(devices)]: on one H100 all 8 shards of `--shards 2,4` sit on cuda:0;
asked for the CPU (devices=["cpu"]), they sit on cpu, the analog of the 8
virtual devices that tests/conftest.py gives JAX. The multi-process form,
with one shard per rank and torch.distributed collectives, is
parallel/distributed.py; both run the per-shard core below (shard_step,
merge_topk, sum_per_qset).
Every result comes back as numpy, so callers that fork never touch CUDA.
"""
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import sw_pallas
from ..ops._cuda import upload


@dataclass(frozen=True)
class Mesh:
    """devices[i][j] holds shard (i, j): query block i, target block j."""
    devices: tuple

    @property
    def shape(self):
        return len(self.devices), len(self.devices[0])

    def device(self, i: int, j: int) -> torch.device:
        return self.devices[i][j]


def default_devices():
    """Every CUDA device of this process; raises without one (a mesh runs
    on the CPU only when its caller names the CPU's devices)."""
    if torch.cuda.is_available():
        return [torch.device("cuda", k)
                for k in range(torch.cuda.device_count())]
    raise RuntimeError(
        "the device mesh (--shards) needs a CUDA device and none is "
        "attached; pass devices=['cpu'] (the CLI: SPACEPHARER_TORCH_DEVICE"
        "=cpu) to run it on the CPU")


def make_mesh(n_query_shards: int = 1, n_target_shards: int = None,
              devices=None) -> Mesh:
    """A (q, t) mesh over `devices` (default: every CUDA device, raising
    without one), shards placed round-robin."""
    devices = [torch.device(d) for d in (devices if devices is not None
                                         else default_devices())]
    if n_target_shards is None:
        n_target_shards = max(1, len(devices) // n_query_shards)
    if n_query_shards < 1 or n_target_shards < 1:
        raise ValueError("a mesh needs at least one shard on each axis")
    return Mesh(tuple(
        tuple(devices[(i * n_target_shards + j) % len(devices)]
              for j in range(n_target_shards))
        for i in range(n_query_shards)))


def sw_score_allpairs(q_prof, q_len, t_seqs, t_len, gap_open: int,
                      gap_extend: int) -> torch.Tensor:
    """All-pairs SW scores int32 [Q, T] on q_prof's device.

    q_prof int32 [Q, LQ, A] per-position profiles, q_len [Q], t_seqs
    int32 [T, LT] (the JAX layout), t_len [T], packed for kernel B4 as
    the mesh below packs each target block. On CPU tensors the plain
    version runs through the same packing."""
    return sw_pallas.sw_scores_packed(
        q_prof, q_len, sw_pallas.pack_targets(t_seqs, t_len,
                                              q_prof.shape[2]),
        gap_open, gap_extend)


def topk_desc(scores, k: int, index=None, n_index: int = None):
    """Top k of every row under (score desc, index asc): the tie rule of
    JAX's lax.top_k, which torch.topk does not promise. `index` gives
    each column's index (default: its position), all below n_index.
    Returns (scores, indices), both [rows, k]."""
    if index is None:
        n_index = scores.shape[1]
        index = torch.arange(n_index, device=scores.device).expand_as(scores)
    key = scores.long() * n_index + (n_index - 1 - index.long())
    _, pos = torch.topk(key, k, dim=1)
    return scores.gather(1, pos), index.gather(1, pos)


def best_per_set(scores, set_of_t, n_sets: int):
    """besthitperset: the best score of each row in each target set,
    floored at 0 (JAX's segment_max, whose empty sets give the int32
    minimum, then maximum(., 0)). int32 [rows, n_sets]."""
    out = torch.zeros((scores.shape[0], n_sets), dtype=torch.int32,
                      device=scores.device)
    idx = set_of_t.long().expand(scores.shape[0], -1)
    return out.scatter_reduce(1, idx, scores, "amax", include_self=True)


def sum_per_qset(best_set, set_of_q, n_qsets: int):
    """combinescore analog: per (query set, target set) the sum of member
    rows' best-set scores. int32 [n_qsets, n_sets]."""
    out = torch.zeros((n_qsets, best_set.shape[1]), dtype=torch.int32,
                      device=best_set.device)
    return out.index_add_(0, set_of_q.long(), best_set)


def shard_step(q_prof, q_len, targets, top_k: int, t_offset: int,
               set_of_t=None, n_sets: int = 0, gap_open: int = 16,
               gap_extend: int = 2):
    """The per-shard core: SW scores of the shard (targets packed by
    sw_pallas.pack_targets), their top-k with global target ids (local
    id + t_offset), and, when set_of_t is given, the best score per
    target set. Returns (scores [Ql, k'], ids [Ql, k'], best_set [Ql,
    n_sets] or None), k' = min(top_k, local targets)."""
    scores = sw_pallas.sw_scores_packed(q_prof, q_len, targets, gap_open,
                                        gap_extend)
    sc, idx = topk_desc(scores, min(top_k, scores.shape[1]))
    best = None if set_of_t is None else best_per_set(scores, set_of_t,
                                                      n_sets)
    return sc, idx + t_offset, best


def merge_topk(sc_list, idx_list, top_k: int, n_targets: int):
    """mergeTargetSplits: the global top-k from the t shards' top-k
    lists, under (score desc, global id asc)."""
    return topk_desc(torch.cat(sc_list, dim=1), top_k,
                     index=torch.cat(idx_list, dim=1), n_index=n_targets)


def _split(mesh, Q, T):
    nq, nt = mesh.shape
    if Q % nq or T % nt:
        raise ValueError(f"{Q} queries and {T} targets do not split over "
                         f"a {nq}x{nt} mesh")
    return Q // nq, T // nt


def _placer(alpha: int):
    """(on, packed): on(dev, key, x) is x copied to dev, contiguous, and
    packed(dev, j, t_block, t_len_block) the target block j packed for
    kernel B4 on dev (a profile of width alpha), each made once per
    device, so a target block is packed once and not once per q shard."""
    placed = {}

    def on(dev, key, x):
        if (dev, key) not in placed:
            placed[(dev, key)] = upload(x, dev).contiguous()
        return placed[(dev, key)]

    def packed(dev, j, t_block, t_len_block):
        if (dev, ("tp", j)) not in placed:
            placed[(dev, ("tp", j))] = sw_pallas.pack_targets(
                upload(t_block, dev), upload(t_len_block, dev), alpha)
        return placed[(dev, ("tp", j))]
    return on, packed


def _run_mesh(mesh, q_prof, q_len, t_seqs, t_len, top_k, set_of_t=None,
              n_sets=0, gap_open=16, gap_extend=2):
    """Every shard's core, then the merge over t per query block, on the
    device of the block's shard (i, 0). Yields (i, sc2, idx2, best_set)."""
    nq, nt = mesh.shape
    q_prof, q_len, t_seqs, t_len = (
        torch.as_tensor(x, dtype=torch.int32)
        for x in (q_prof, q_len, t_seqs, t_len))
    if set_of_t is not None:
        set_of_t = torch.as_tensor(set_of_t, dtype=torch.int32)
    ql, tl = _split(mesh, q_prof.shape[0], t_seqs.shape[0])
    on, packed = _placer(q_prof.shape[2])
    for i in range(nq):
        home = mesh.device(i, 0)
        qs = slice(i * ql, (i + 1) * ql)
        sc_l, idx_l, best = [], [], None
        for j in range(nt):
            dev = mesh.device(i, j)
            ts = slice(j * tl, (j + 1) * tl)
            sc, idx, b = shard_step(
                on(dev, ("qp", i), q_prof[qs]), on(dev, ("ql", i), q_len[qs]),
                packed(dev, j, t_seqs[ts], t_len[ts]), top_k, j * tl,
                None if set_of_t is None else on(dev, ("st", j),
                                                 set_of_t[ts]),
                n_sets, gap_open, gap_extend)
            sc_l.append(sc.to(home))
            idx_l.append(idx.to(home))
            if b is not None:
                best = b.to(home) if best is None else torch.maximum(
                    best, b.to(home))
        sc2, idx2 = merge_topk(sc_l, idx_l, top_k, t_seqs.shape[0])
        yield i, sc2, idx2, best


def sharded_search_step(mesh: Mesh, top_k: int = 8):
    """The sharded scoring step.

    step(q_prof, q_len, t_seqs, t_len) -> (scores, idx), numpy [Q, top_k]:
      q_prof int32 [Q, LQ, A] per-position query profiles (q-sharded)
      q_len  int32 [Q]
      t_seqs int32 [T, LT]    target sequences, numeric (t-sharded)
      t_len  int32 [T]
    The global top-k of every query's all-pairs SW scores under (score
    desc, index asc); the [Q, T] matrix exists only shard by shard."""
    def step(q_prof, q_len, t_seqs, t_len):
        rows = [(sc2.cpu(), idx2.cpu()) for _, sc2, idx2, _ in _run_mesh(
            mesh, q_prof, q_len, t_seqs, t_len, top_k)]
        return (torch.cat([r[0] for r in rows]).numpy(),
                torch.cat([r[1] for r in rows]).int().numpy())

    return step


def sharded_search_pipeline(mesh: Mesh, top_k: int, n_sets: int,
                            n_qsets: int = 0):
    """The full sharded search step: per-shard all-pairs SW, the global
    top-k merge over ``t`` (Prefiltering.h:49 mergeTargetSplits),
    best-hit-per-target-set (multihit/besthitperset.cpp as scatter-amax
    and a max over ``t``), and, with ``n_qsets``, the combinescore-shaped
    query-set sum (CombineScore.cpp:41-98 as a scatter-add and a sum over
    ``q``; query sets may straddle q shards).

    step(q_prof, q_len, t_seqs, t_len, set_of_t[, set_of_q]) ->
      (top_scores [Q, k], top_idx [Q, k] global target ids,
       best_per_set [Q, n_sets][, combined [n_qsets, n_sets]]), numpy."""
    def step(q_prof, q_len, t_seqs, t_len, set_of_t, set_of_q=None):
        sc, idx, best, comb = [], [], [], None
        ql = _split(mesh, len(q_prof), len(t_seqs))[0]
        for i, sc2, idx2, b in _run_mesh(mesh, q_prof, q_len, t_seqs, t_len,
                                         top_k, set_of_t, n_sets):
            sc.append(sc2.cpu())
            idx.append(idx2.cpu())
            best.append(b.cpu())
            if n_qsets:
                part = sum_per_qset(b, torch.as_tensor(set_of_q)[
                    i * ql:(i + 1) * ql].to(b.device), n_qsets).cpu()
                comb = part if comb is None else comb + part
        out = (torch.cat(sc).numpy(), torch.cat(idx).int().numpy(),
               torch.cat(best).numpy())
        return out + (comb.numpy(),) if n_qsets else out

    return step


def sharded_allpairs_scores(mesh: Mesh, q_list, t_list, matrix_scores,
                            bias_list=None, gap_open: int = 16,
                            gap_extend: int = 2) -> np.ndarray:
    """All-pairs SW scores int32 [len(q_list), len(t_list)] over a (q, t)
    mesh: the scoring engine of `--shards`.

    Query rows ride the ``q`` axis and the target ORFs the ``t`` axis;
    each split is contiguous and padded with empty sequences, which score
    0. Cells are exact, so the pipeline's output is byte-identical
    whatever the mesh shape."""
    nq_sh, nt_sh = mesh.shape
    lq = max(8, ((max((len(q) for q in q_list), default=1) + 7) // 8) * 8)
    lt = max(8, ((max((len(t) for t in t_list), default=1) + 7) // 8) * 8)
    Q = -(-len(q_list) // nq_sh) * nq_sh
    T = -(-len(t_list) // nt_sh) * nt_sh
    q_pad = list(q_list) + [np.zeros(0, np.int64)] * (Q - len(q_list))
    t_pad = list(t_list) + [np.zeros(0, np.int64)] * (T - len(t_list))
    if bias_list is not None:
        bias_list = list(bias_list) + [np.zeros(0)] * (Q - len(q_list))
    q_prof, q_len = pack_queries(q_pad, matrix_scores, lq,
                                 bias_list=bias_list)
    t_seqs, t_len = pack_targets(t_pad, lt, x_index=20)

    ql, tl = Q // nq_sh, T // nt_sh
    q_prof, q_len = torch.from_numpy(q_prof), torch.from_numpy(q_len)
    t_seqs, t_len = torch.from_numpy(t_seqs), torch.from_numpy(t_len)
    out = np.empty((Q, T), dtype=np.int32)
    on, packed = _placer(q_prof.shape[2])
    for i in range(nq_sh):
        qs = slice(i * ql, (i + 1) * ql)
        for j in range(nt_sh):
            dev = mesh.device(i, j)
            ts = slice(j * tl, (j + 1) * tl)
            out[qs, ts] = sw_pallas.sw_scores_packed(
                on(dev, ("qp", i), q_prof[qs]), on(dev, ("ql", i), q_len[qs]),
                packed(dev, j, t_seqs[ts], t_len[ts]),
                gap_open, gap_extend).cpu().numpy()
    return out[:len(q_list), :len(t_list)]


def pack_queries(q_list, matrix_scores, lq, bias_list=None):
    """Queries -> per-position profiles [Q, LQ, A] (int32) + lengths."""
    A = matrix_scores.shape[0]
    Q = len(q_list)
    prof = np.full((Q, lq, A), -(10 ** 6), dtype=np.int32)
    q_len = np.zeros(Q, dtype=np.int32)
    for i, q in enumerate(q_list):
        q = np.asarray(q, dtype=np.int64)[:lq]
        q_len[i] = len(q)
        p = matrix_scores[q].astype(np.int32)
        if bias_list is not None:
            p = p + np.asarray(bias_list[i], dtype=np.int32)[:len(q), None]
        prof[i, :len(q)] = p
    return prof, q_len


def pack_targets(t_list, lt, x_index: int):
    T = len(t_list)
    seqs = np.full((T, lt), x_index, dtype=np.int32)
    t_len = np.zeros(T, dtype=np.int32)
    for i, t in enumerate(t_list):
        t = np.asarray(t, dtype=np.int64)[:lt]
        t_len[i] = len(t)
        seqs[i, :len(t)] = t
    return seqs, t_len
