"""Multi-process execution (the reference's MPI analog).

The port of spacepharer_tpu/parallel/distributed.py. The reference
distributes by assigning target-DB splits to MPI ranks and merging
result files (Prefiltering::runMpiSplits,
lib/mmseqs/src/prefiltering/Prefiltering.cpp:559-600). Here one process
per (q, t) shard runs the per-shard core of parallel/sharding.py, and the
merges are torch.distributed collectives: the top-k merge an all_gather
over the shard's t group, best-hit-per-set an all_reduce(MAX) over it,
the query-set sum an all_reduce(SUM) over the q group. NCCL carries them
between GPUs, gloo between CPU processes.

Launch one process per shard with the usual torch.distributed variables
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) or pass them explicitly:

    from spacepharer_tpu_torch.parallel.distributed import (
        initialize, distributed_search_pipeline)
    rank, world = initialize()
    step = distributed_search_pipeline(n_q, n_t, top_k=..., n_sets=...)

Each process loads only its target shard's slice of the SetDB
(`shard_indices` below). NCCL cannot hold two ranks on one GPU: on one
card the NCCL form runs at world size 1.
"""
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..ops.sw_pallas import pack_targets
from .sharding import merge_topk, shard_step, sum_per_qset


def initialize(init_method=None, world_size=None, rank=None, backend=None,
               timeout_s: float = 300.0):
    """torch.distributed.init_process_group, NCCL when CUDA is present
    and gloo otherwise, from the environment (env://) or from explicit
    arguments. Returns (rank, world size)."""
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    kwargs = {}
    if init_method is not None:
        kwargs.update(init_method=init_method, world_size=world_size,
                      rank=rank)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank if rank is not None
                                   else os.environ.get("RANK", 0)))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend, timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return dist.get_rank(), dist.get_world_size()


def shard_indices(n_items: int, n_shards: int, shard: int) -> np.ndarray:
    """Contiguous, balanced split of item indices (target ORFs per host),
    mirroring the reference's round-capacity split assignment."""
    bounds = np.linspace(0, n_items, n_shards + 1).astype(np.int64)
    return np.arange(bounds[shard], bounds[shard + 1])


def host_local_targets(target_db, n_shards: int, shard: int):
    """The ORF slice this host contributes to the global t-sharded array."""
    idx = shard_indices(target_db.n_orfs, n_shards, shard)
    from ..alphabet import encode_aa
    return [encode_aa(target_db.orf_aa(int(i)).tobytes()) for i in idx], idx


def _group(ranks, world):
    # every rank must create every group, in the same order
    return None if len(ranks) == world else dist.new_group(ranks=ranks)


def distributed_search_pipeline(n_q: int, n_t: int, top_k: int, n_sets: int,
                                n_qsets: int = 0, device=None,
                                gap_open: int = 16, gap_extend: int = 2):
    """sharded_search_pipeline with one (q, t) shard per rank of the
    initialised process group (rank = i * n_t + j); call it on every
    rank.

    step(q_prof, q_len, t_seqs, t_len, set_of_t[, set_of_q]) takes this
    rank's shard (query block i, target block j, every target block of
    the same size) and returns numpy (top_scores [Ql, k], top_idx [Ql, k]
    global target ids, best_per_set [Ql, n_sets][, combined [n_qsets,
    n_sets]]) for query block i; `combined` is the same on every rank."""
    world = dist.get_world_size()
    if world != n_q * n_t:
        raise ValueError(f"a {n_q}x{n_t} mesh needs {n_q * n_t} ranks, the "
                         f"group has {world}")
    i, j = divmod(dist.get_rank(), n_t)
    t_groups = [_group([a * n_t + b for b in range(n_t)], world)
                for a in range(n_q)]
    q_groups = [_group([a * n_t + b for a in range(n_q)], world)
                for b in range(n_t)]
    t_group, q_group = t_groups[i], q_groups[j]
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))

    def step(q_prof, q_len, t_seqs, t_len, set_of_t, set_of_q=None):
        def dev(x):
            return torch.as_tensor(x, dtype=torch.int32).to(device)
        t_local = len(t_seqs)
        qp = dev(q_prof)
        sc, idx, best = shard_step(qp, dev(q_len),
                                   pack_targets(dev(t_seqs), dev(t_len),
                                                qp.shape[2]),
                                   top_k, j * t_local, dev(set_of_t), n_sets,
                                   gap_open, gap_extend)
        sc_all = [torch.empty_like(sc) for _ in range(n_t)]
        idx_all = [torch.empty_like(idx) for _ in range(n_t)]
        dist.all_gather(sc_all, sc.contiguous(), group=t_group)
        dist.all_gather(idx_all, idx.contiguous(), group=t_group)
        sc2, idx2 = merge_topk(sc_all, idx_all, top_k, n_t * t_local)
        dist.all_reduce(best, op=dist.ReduceOp.MAX, group=t_group)
        out = (sc2.cpu().numpy(), idx2.int().cpu().numpy(),
               best.cpu().numpy())
        if not n_qsets:
            return out
        comb = sum_per_qset(best, dev(set_of_q), n_qsets)
        dist.all_reduce(comb, op=dist.ReduceOp.SUM, group=q_group)
        return out + (comb.cpu().numpy(),)

    return step
