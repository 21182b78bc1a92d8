#!/usr/bin/env python3
"""Smoke run of spacepharer_tpu_torch, the PyTorch/CUDA port, on one GPU.

    python3 chip_smoke.py [--seed 0]

Phase 0  requires CUDA, prints the card (nvidia-smi) and builds the
         hand-written kernels (csrc/sw_allpairs.cu with B1's dense and
         pair-list entries, csrc/pair_profile.cu, csrc/prefilter_dense.cu,
         csrc/prefilter_streams.cu and csrc/sw_dense.cu, one nvcc each, in
         parallel, sm_90a), printing each entry's registers and spills,
         and counts in the SASS of the built libraries (cuobjdump -sass),
         per kernel function, the DPX min/max opcodes of sw_allpairs and
         sw_dense (and the shuffles of sw_allpairs, whose pair-list tail
         passes each row's left edge between lanes), the float64 opcodes
         of pair_profile, the integer MMA
         opcodes of prefilter_dense (wgmma's IGMMA, mma.sync's IMMA) and
         the warp match and vote opcodes of prefilter_streams; it fails if
         the counts kernel has no IGMMA or any IMMA, or if the profile
         kernel has a DFMA.
Phase 1  holds B1's dense entry against its plain PyTorch version on the
         card, exactly, on the test corpora and on a production-shaped
         workload (the golden bundle's 305 query ORFs x 691 target ORFs,
         targets x20), and times both (true DP cells per second): the
         wrapper's chain here, the kernel alone in phase 5(b); and the
         pair-list entry on
         every cell of each test corpus (shuffled, each pair twice)
         against its plain version and the dense entry, exactly.
Phase 2  runs the golden bundle's DBs through the CLI `predictmatch`
         with --use-tpu 1 and requires the golden result.tsv, byte for
         byte, with the pair kernel launched.
Phase 3  builds a real-size corpus from the golden bundle and --seed
         (COPIES point-mutated copies of each golden genome; the golden
         spacers plus SETS random sets of 3 spacers) and runs
         `predictmatch` with the host engine (a fresh process, as a user
         runs it) and with the GPU scoring engine forced on and the host
         prefilter (in this process, so the kernel's launches are
         counted), each on its own copy of the DBs; both texts must
         agree, and the GPU run's _search_tpu prints where its time goes
         (host bias, scoring, E-value screen, survivor alignment), the
         scoring step's own split (the query profiles with their
         composition bias built on the card, uploads, the pair entry's
         key pass, sort and launches, read-back)
         and the torch probe's wait. Every query profile the profile
         kernel built (every query of both searches) and every candidate
         pair the pair kernel scored, and every key pass the pair entry
         ran, are then held against their plain versions on the card;
         each is timed at the first search's inputs
         (beside phase 4(b)'s profiler sessions) by torch.profiler's
         device time beside its bound (the profile step: every kernel and
         memset its wrapper runs; the pair entry's key pass and kernel,
         PAIR_FUNCTIONS, beside the sort and the rest), and the distinct
         profile words per warp load are counted. It prints the auto
         gate's prefilter choice for the corpus's shape. (b) fits the
         auto gates' host terms on the card's host: the host walk's
         postings build and k-mer walk (GATE_RUNS fresh processes,
         medians), and the scoring
         gate's break-even in candidate cells from the search stage of
         the GPU and host engines under `auto` (the gate forced each way,
         the host prefilter), alternating fresh runs (GATE_SHAPE_RUNS per
         engine) at phase 3's corpus and at its query side
         GATE_BIG_COPIES and GATE_HUGE_COPIES times over, texts equal, a
         line fitted through each engine's medians; and at one point on
         the target axis (phase 3's query side against GATE_TARGET_COPIES
         mutated copies of each golden genome) both engines' medians
         beside the lines' predictions for its candidate cells.
Phase 4  the dense prefilter's kernel (counts_kernel, the pass that
         writes every hit) and its stream kernels
         (csrc/prefilter_streams.cu: rank tables, key build, run
         reduction): (a) the pass's hits against its plain version's as a
         sorted set, exactly, also into a buffer of half the hits (run
         again into one of exactly the hits), on the `cuda` cases of
         tests/test_torch_prefilter_dense.py, and match_pairs with small
         chunk and buffer bounds against the numpy oracle; the stream
         kernels against their plain versions on those cases' own hits
         and on the random and seam cases of
         tests/test_torch_prefilter_streams.py (keys too wide for one
         sort, a run across many blocks, every query half among them);
         (b) at the production shape (phase 3's query k-mer rows x its
         whole masked target; tools/time_kernels.py --entry counts times
         the pass there for two checkouts, parent against change), exact
         and timed (the kernel alone on the compacted rows, the
         compaction apart,
         the wrapper with the cursor's read-back and the hits' copy, the
         plain version), with its share of its bound, torch._int_mm on the
         same
         compacted int8 product in column blocks (the library yardstick;
         the port never calls it), two of the auto gate's constants (the
         whole dense pass's cells per second, and the fixed cost of a
         dense run in a fresh process), and the three stream kernels on
         the dense pass's own hits, exact against their plain versions
         on the card and each timed alone (device time by
         torch.profiler) beside its bound in bytes, the sort (torch.sort)
         timed apart, and the rank
         tables' library yardstick (torch.sort of every half's 8,000
         scores); (c) `predictmatch` through the CLI on phase 3's corpus
         (its own DB copy) with --prefilter-engine device --use-tpu 0,
         in this process so that the launches are counted, whose text
         must equal phase 3's host-engine text with the dense and every
         stream kernel launched and no chunk run again, with where
         device_prefilter's time goes (the dense pass, the query
         packing, the stream rebuild, the batch finalize, the rest) and
         the alignment; (d) the
         dense and host routes in fresh
         processes, as a user runs them, at four shapes (phase 3's
         corpus, its first SMALL_SETS spacer sets against the same
         target, its query side GATE_BIG_COPIES times over, and its
         query side against phase 3(b)'s target-axis point), their texts
         equal, and the gate's fixed cost and host-work terms fitted to
         the four walls' differences with (b)'s cell rate and phase
         3(b)'s host walk terms.
Phase 5  the device mesh (--shards) and its dense SW kernels B3 (one
         query) and B4 (a query batch), csrc/sw_dense.cu: (a) both against
         their plain versions, exactly, on the `cuda` cases of
         tests/test_torch_sw_pallas.py; (b), run right after phase 4(b)
         so that every profiler session of the run is held in one
         stretch (a session held earlier once left later ones empty), B1
         alone at phase 1's shape, then B4 there, exact and timed beside
         B1: the kernel alone (its device time by
         torch.profiler, as every kernel's time in the report), the target
         packing apart, and the wrapper with the packing; and B3 on one of
         its queries, timed
         beside B4 on that one query; (c) the golden DBs
         through the CLI with --shards 2,4, golden bytes; (d) phase 3's
         corpus (its own DB copy) through the CLI with --shards 2,4
         --use-tpu 1 --prefilter-engine host, in this process, whose text
         must equal the host engine's, with where its time goes (_search_tpu
         split as in phase 3) and a sample of its largest block held
         against the plain version; (e)
         graft_entry.dryrun_multichip(8) on the golden DBs and
         distributed_search_pipeline over NCCL at world size
         torch.cuda.device_count() (one process per card), both against
         the exact host oracle. The kernels' launches are counted over
         (c) and (d), the slice's main path. B3 has no product caller (nor
         has its TPU kernel): it is held in (a) and (b) and reports 0
         launches there.
Phase 6  the product surface as a user runs it, through the launcher
         bin/spacepharer_torch: (a) the golden run's inputs written back
         as files (three gzipped genome FASTAs, two spacer files) and
         createsetdb plain and with --reverse-fragments 1, each in a fresh
         process; (b) easy-predict with the auto gates in a fresh process
         (the prefilter and scoring engines the gates picked are
         printed), then in this process with --use-tpu 1 (B1's pair
         entry must launch) and with --prefilter-engine device
         --use-tpu 0 (the B2 kernel must launch), each giving the
         golden result.tsv byte for byte;
         (c) B2's pass on each dense search's own inputs from (b) (the
         golden query k-mer rows x the golden masked target), exact
         against its plain version; (d) searchnucl on
         tests/blastn_fixtures.tar.gz's fix, fix2 and fix3 in fresh
         processes, each giving the reference binary's ref.m8 byte for
         byte; (e) each run's wall and the phase's own beside the card's
         name and power limit. Its launches are printed on a line of
         their own and are not the kernel report's (the main path's); (c)
         adds to the report's max errors of B2.

Each kernel's entry in the report carries its bound: the larger of its
bytes (every input read once, every output written once) over 3.35 TB/s
and its operations over the card's rate for their type, both counted for
what this run's inputs need. The profile kernel counts its letters, query
offsets, matrix and table read and its int8 profile written as bytes, and
FLOAT64_OPS_PER_RESIDUE float64 operations per residue over the card's
float64 rate (and one int32 operation per window term and profile entry
over its int32 rate, the larger of the two). The SW kernels count the
profile rows within
each query's length, each target's true letters, the lengths and the
scores as bytes (the pair entry: the int8 rows of the queries its pairs
name, the letters of the targets they name, and the pair list), and
SW_OPS_PER_CELL int32 operations per true DP cell
over 132 SMs x 64 int32 lanes x clocks.max.sm; B2 counts its product as
int8 (2 x 128 per cell of the rows that can match) over 1,979 TOP/s.

Every failure exits non-zero. The last two lines of standard output are
the kernel report and the run's result, one JSON object each. B1's dense
entry and B3 have no product caller: they are held against their plain
versions and report 0 launches on the main path.
"""
import argparse
import collections
import concurrent.futures
import contextlib
import glob
import gzip
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tarfile
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
KERNELS = {   # library name -> (source, the TPU kernel it replaces)
    "sw_allpairs": ("spacepharer_tpu_torch/csrc/sw_allpairs.cu",
                    "spacepharer_tpu/ops/sw_packed.py:81"),
    # no TPU kernel: the JAX package's host loop over sw_bias_i8
    "pair_profile": ("spacepharer_tpu_torch/csrc/pair_profile.cu",
                     "spacepharer_tpu/pipeline/predictmatch.py:602"),
    "prefilter_dense": ("spacepharer_tpu_torch/csrc/prefilter_dense.cu",
                        "spacepharer_tpu/ops/prefilter_dense.py:256"),
    "sw_dense": ("spacepharer_tpu_torch/csrc/sw_dense.cu",
                 "spacepharer_tpu/ops/sw_pallas.py:124"),
    # no TPU kernel: the JAX package's host hits_to_streams (numpy)
    "prefilter_streams": ("spacepharer_tpu_torch/csrc/prefilter_streams.cu",
                          "spacepharer_tpu/ops/prefilter_dense.py:386"),
}
# the stream rebuild's three wrappers (ops/prefilter_dense.py), each a
# kernel entry of the report: its name there (and its launch counter's,
# less "_launches"), its key in phase 4(b)'s results
STREAM_KERNELS = (("prefilter_streams_ranks", "ranks"),
                  ("prefilter_streams_keys", "keys"),
                  ("prefilter_streams_runs", "runs"))
# the spans of device_pair_scores's steps (the scoring step's split)
PAIR_SPANS = ("pair_profile", "pair_upload", "pair_score", "pair_read_back")
# the kernels of B1's pair-list entry, by kernel_split's names: the key
# pass and the kernel that scores the tail and the bulk in one launch
PAIR_FUNCTIONS = ("pair_keys_kernel", "sw_pairs_kernel")
# the device work of each stream wrapper, by kernel_split's names
STREAM_FUNCTIONS = {"ranks": ("mark_halves_kernel", "slots_kernel",
                              "rank_tables_kernel"),
                    "keys": ("keys_kernel",),
                    "runs": ("memset", "run_count_kernel", "run_write_kernel")}
LAUNCHER = os.path.join(REPO, "bin", "spacepharer_torch")
BLASTN_FIXTURES = ("fix", "fix2", "fix3")   # tests/blastn_fixtures.tar.gz
# the TPU path's hit extraction, which counts_kernel's pass took over
EMIT_REPLACES = "spacepharer_tpu/ops/prefilter_dense.py:228"
ONE_QUERY_REPLACES = "spacepharer_tpu/ops/sw_pallas.py:35"
COPIES = 100          # mutated copies of each golden genome (phase 3)
SETS = 2000           # random spacer sets added to the golden ones
SMALL_SETS = 20       # random sets of phase 4(d)'s small query side
CHECK_ROWS = 16       # query rows of phase 5's largest block checked
GATE_RUNS = 3         # phase 3(b): fresh host-walk probes
P1_DUP = 20           # phase 1: golden target ORFs repeated this often
P1_KERNEL_CALLS = 10  # phase 1: calls per timed kernel chain
P3_PAIR_CALLS = 10    # phase 3: calls of the pair kernel timed alone
GATE_BIG_COPIES = 10  # phase 3(b): copies of the query side, second shape
GATE_HUGE_COPIES = 30  # phase 3(b): copies of the query side, third shape
GATE_TARGET_COPIES = 300  # phase 3(b): mutated copies of each genome, the
                          # target-axis point (3 x COPIES)
# phase 3(b): alternating fresh runs per engine at each query-side shape
# (copies) and at the target-axis point ("t"); one run at x30, whose two
# runs per engine took ~340 s of the phase's 679 s on an NVIDIA H100 80GB
# HBM3 (700 W) machine, and one on the target axis, which phase 4(d) runs
# again for the dense gate
GATE_SHAPE_RUNS = {1: 3, GATE_BIG_COPIES: 2, GATE_HUGE_COPIES: 1, "t": 1}
P3_PROFILE_CALLS = 20  # phase 3: calls of the profile kernel timed alone
P4_KERNEL_CALLS = 3   # phase 4(b): calls per timed kernel chain
P5_KERNEL_CALLS = 5   # phase 5(b): calls per timed kernel chain
# SASS opcodes counted per kernel function in phase 0: the min/max family
# of sw_dense and of sw_allpairs (their DPX add-max and three-way max among
# them; and sw_allpairs' shuffles) and the integer MMA of prefilter_dense
# (wgmma's IGMMA in counts_kernel; mma.sync's IMMA, which it must not use)
SASS_COUNTED = {"sw_dense": re.compile(r"MNMX"),
                "sw_allpairs": re.compile(r"MNMX|^SHFL"),
                "pair_profile": re.compile(r"^D(ADD|MUL|FMA)|^MUFU"),
                "prefilter_dense": re.compile(r"^IMMA|^IGMMA|^LDSM"),
                "prefilter_streams": re.compile(r"^MATCH|^VOTE")}
# the card's peak rates for the bounds (NVIDIA's H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
FLOAT64_OPS_PER_S = 3.4e13      # outside the tensor cores
# least float64 operations per residue of the profile kernel's bias: the
# divide, the add of the expected score, the +-0.5 and the floor or ceil
FLOAT64_OPS_PER_RESIDUE = 4
SMS, INT32_LANES = 132, 64
# least int32 operations per true SW cell (a DPX add-max or three-way max
# counts as one): h_pre = addmax(diag, S, E); t = h_pre - go;
# E' = addmax_relu(E, -ge, t); H = max(h_pre, F); F' = addmax(F, -ge, t);
# best = max(best, H)
SW_OPS_PER_CELL = 6
# least int32 operations per pair of the pair entry's key pass: stripes
# (add, shift), work (multiply), the tail test, the key (two clamps, two
# shifts, two ors), the scratch need (test, add, shift) and the true cells
# (multiply)
PAIR_KEY_OPS = 14
# kernels whose TPU counterpart no product path calls: held against their
# plain versions, never launched on the main path
NO_PRODUCT_CALLER = ("sw_dense_one_query", "sw_allpairs")


def _golden_dir(tmp):
    tar = os.path.join(REPO, "tests", "golden_run.tar.gz")
    with tarfile.open(tar) as tf:
        tf.extractall(tmp, filter="fully_trusted")   # the repo's own bundle
    return os.path.join(tmp, "run")


def _golden_query_path(golden):
    (qpath,) = {os.path.realpath(p) for p in
                glob.glob(os.path.join(golden, "tmp", "*", "qsetdb"))}
    return qpath


# ---------------------------------------------------------------- phase 1

def _corpora(m):
    """(name, queries, targets, biases, gap_open, gap_extend): the cases
    of tests/test_torch_sw_packed.py plus a query past 2048 rows whose
    score bound is far above 4096."""
    out = []
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        qs = [rng.integers(0, 20, int(rng.integers(3, 25))) for _ in range(9)]
        ts = [rng.integers(0, 20, int(rng.integers(5, 90)))
              for _ in range(23)]
        out.append((f"seed{seed}", qs, ts,
                    [rng.integers(-3, 4, len(q)) for q in qs], 16, 2))
    rng = np.random.default_rng(11)
    out.append(("multiblock",
                [rng.integers(0, 20, int(rng.integers(3, 20)))
                 for _ in range(14)],
                [rng.integers(0, 20, int(rng.integers(5, 70)))
                 for _ in range(9)], None, 16, 2))
    rng = np.random.default_rng(3)
    top = int(np.argmax(np.diag(m.scores[:20, :20])))
    big = np.full(400, top, dtype=np.int64)
    small = [rng.integers(0, 20, int(rng.integers(5, 20))) for _ in range(4)]
    out.append(("big_query", small[:2] + [big] + small[2:],
                [rng.integers(0, 20, int(rng.integers(10, 80)))
                 for _ in range(7)] + [big[:300].copy()], None, 16, 2))
    rng = np.random.default_rng(7)
    out.append(("x_gap10_1",
                [rng.integers(0, 21, int(rng.integers(4, 20)))
                 for _ in range(5)],
                [rng.integers(0, 21, int(rng.integers(8, 60)))
                 for _ in range(17)], None, 10, 1))
    rng = np.random.default_rng(13)
    huge = np.full(2300, top, dtype=np.int64)
    out.append(("long_query_2300",
                [huge, rng.integers(0, 21, 40), huge[:17], huge[:16]],
                [huge[:1800].copy(), rng.integers(0, 21, 700),
                 rng.integers(0, 21, 3)],
                [rng.integers(-3, 4, 2300), None, None, None], 16, 2))
    return out


def _to_device(dev, qpack, tpack):
    import torch
    return tuple(torch.from_numpy(a).to(dev) for a in (
        qpack["prof"], qpack["q_off"], tpack["t_seqs"], tpack["t_off"],
        tpack["t_len"]))


def _pair_args(dev, qs, ts, biases, m, pair_q, pair_t):
    """sw_pairs' tensors on dev (prof, q_stripe, q_len, t_seqs, t_off,
    pair_q, pair_t) for the pairs (qs[pair_q[p]], ts[pair_t[p]])."""
    import torch
    from spacepharer_tpu_torch.ops import sw_packed
    qp = sw_packed.pack_pair_queries(qs, m.scores, biases, dev)
    t_off = np.zeros(len(ts) + 1, dtype=np.int64)
    np.cumsum([len(t) for t in ts], out=t_off[1:])
    t_flat = np.concatenate(ts + [np.zeros(sw_packed.T_PAD)]).astype(
        np.uint8)
    return (qp["prof"], qp["q_stripe"], qp["q_len"]) + tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
            t_flat, t_off, np.asarray(pair_q, dtype=np.int32),
            np.asarray(pair_t, dtype=np.int32)))


def _chain_out(fn, args, go, ge, n, warm=True):
    """(mean ms, last output) of n data-dependent calls (each call's
    profile depends on the previous call's output), timed with CUDA
    events and ended by a host fetch of the last output."""
    import torch
    prof, rest = args[0], args[1:]
    if warm:
        fn(prof, *rest, go, ge)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    p = prof
    start.record()
    for _ in range(n):
        out = fn(p, *rest, go, ge)
        p = prof + (out.reshape(-1)[0] & 0)
    total = out.sum()
    stop.record()
    total.item()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n, out


def _chain_ms(fn, args, go, ge, n):
    return _chain_out(fn, args, go, ge, n)[0]


# idle seconds at each end of a profiler session. torch.profiler keeps
# a device record only where its time, mapped to the host's clock, falls
# inside the session; on the H100 (PyTorch 2.11, CUDA 12.8) that mapping
# strays by milliseconds (kernels stamped up to 3.6 ms before their own
# launch), and sessions a few ms long kept their launches but lost every
# kernel (3 of 320 sessions without padding, none of 200 padded)
SESSION_PAD_S = 0.1


def kernel_split(calls):
    """{name: device ms} of what calls() runs on the card, by
    torch.profiler (CUPTI): the port's own kernels by function name (those
    in an anonymous namespace), torch.sort's radix sort as "sort",
    memsets as "memset", PyTorch's other kernels as "other". The card is
    idle at the session's start and end (SESSION_PAD_S each). The port's
    one clock for a kernel alone: this smoke run and tools/time_kernels.py
    read kernel time only through it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(SESSION_PAD_S)
        calls()
        torch.cuda.synchronize()
        time.sleep(SESSION_PAD_S)
    split = collections.Counter()
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        us = e.cuda_time_total if us is None else us
        own = re.search(r"\(anonymous namespace\)::(\w+)\(", e.key)
        if own and "at::" not in e.key:
            split[own.group(1)] += us / 1e3
        elif re.search(r"[Rr]adix", e.key):
            split["sort"] += us / 1e3
        elif e.key.startswith("Memset"):
            split["memset"] += us / 1e3
        elif us > 0 and re.search(r"[Kk]ernel", e.key):
            split["other"] += us / 1e3
    return split


def device_split(fn, args, n, names=None):
    """({name: mean device ms per call} of fn(*args) by kernel_split over
    n calls, last output). One warm-up call. Raises unless the profiler
    saw device work, and every kernel (*_kernel) of `names`."""
    outs = [fn(*args)]
    split = kernel_split(lambda: outs.extend(fn(*args) for _ in range(n)))
    if not split or not all(k in split for k in names or ()
                            if k.endswith("_kernel")):
        raise AssertionError(f"the profiler saw {sorted(split)} over {n} "
                             f"calls, not all of {names or 'device work'}")
    return {k: v / n for k, v in split.items()}, outs[-1]


def named_ms(split, names):
    """The ms of split's entries named `names` (all of them where None)."""
    return sum(v for k, v in split.items() if names is None or k in names)


def device_ms(fn, args, names, n):
    """(mean device ms per call of fn(*args), by torch.profiler over n
    calls: named_ms of device_split's split; last output)."""
    split, out = device_split(fn, args, n, names)
    return named_ms(split, names), out


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _sw_bytes(q_len, alpha, t_len, letter_bytes):
    """Bytes an SW kernel must move for these inputs: the int32 profile
    rows within each query's length (alpha columns each), each target's
    true letters, both length vectors and the int32 [Q, T] scores."""
    q_len = np.asarray(q_len).reshape(-1).astype(np.int64)
    t_len = np.asarray(t_len).reshape(-1).astype(np.int64)
    return (4 * alpha * int(q_len.sum()) + letter_bytes * int(t_len.sum())
            + 4 * (q_len.size + t_len.size) + 4 * q_len.size * t_len.size)


def _bound(n_bytes, ops, ops_per_s):
    """(bound ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _sw_bound(n_bytes, cells, clock_hz):
    return _bound(n_bytes, cells * SW_OPS_PER_CELL,
                  SMS * INT32_LANES * clock_hz)


def phase1(dev, golden):
    import torch
    from spacepharer_tpu_torch.io.setdb import SetDB
    from spacepharer_tpu_torch.ops import sw_packed
    from spacepharer_tpu_torch.ops.align import sw_bias_i8
    from spacepharer_tpu_torch.ops.matrices import load_matrix

    m = load_matrix("VTML40.out", 2.0)
    max_err = pair_err = 0
    for name, qs, ts, biases, go, ge in _corpora(m):
        if biases is not None:
            biases = [np.zeros(len(q), np.int64) if b is None else b
                      for q, b in zip(qs, biases)]
        args = _to_device(dev, sw_packed.pack_queries(qs, m.scores, biases),
                          sw_packed.pack_targets(ts))
        got = sw_packed.sw_allpairs(*args, go, ge)
        ref = sw_packed.sw_allpairs_plain(*args, go, ge)
        err = int((got - ref).abs().max())
        max_err = max(max_err, err)
        # the pair-list entry on every cell, shuffled, each twice
        rng = np.random.default_rng(len(qs))
        flat = np.concatenate([rng.permutation(len(qs) * len(ts))] * 2)
        pair_q, pair_t = np.divmod(flat, len(ts))
        pairs = _pair_args(dev, qs, ts, biases, m, pair_q, pair_t)
        p_got = sw_packed.sw_pairs(*pairs, go, ge)
        p_err = int((p_got - sw_packed.sw_pairs_plain(*pairs, go, ge))
                    .abs().max())
        dense = np.empty((len(qs), len(ts)), dtype=np.int64)
        dense[:, sw_packed.pack_targets(ts)["order"]] = got.cpu().numpy()
        x_err = int(np.abs(p_got.cpu().numpy() - dense[pair_q, pair_t])
                    .max())
        pair_err = max(pair_err, p_err, x_err)
        print(f"phase1 {name}: {len(qs)}x{len(ts)} max|kernel-plain| = "
              f"{err}; pair entry on {len(flat)} pairs max|kernel-plain| = "
              f"{p_err}, max|pairs-dense| = {x_err}")
        if err or p_err or x_err:
            raise AssertionError(f"phase1 {name}: kernel != plain")

    # production shape: golden spacer ORFs x golden target ORFs x dup
    qdb = SetDB.load(_golden_query_path(golden))
    tdb = SetDB.load(os.path.join(golden, "targets"))
    qf, qo = qdb.orf_aa_encoded()
    tf, to = tdb.orf_aa_encoded()
    qs = [qf[qo[i]:qo[i + 1]] for i in range(qdb.n_orfs)]
    ts = [tf[to[i]:to[i + 1]] for i in range(tdb.n_orfs)] * P1_DUP
    biases = [sw_bias_i8(q, m) for q in qs]
    args = _to_device(dev, sw_packed.pack_queries(qs, m.scores, biases),
                      sw_packed.pack_targets(ts))
    got = sw_packed.sw_allpairs(*args, 16, 2)
    # the plain version once, timed (the check's own call is its turn)
    p_ms, ref = _chain_out(sw_packed.sw_allpairs_plain, args, 16, 2, 1,
                           warm=False)
    err = int((got - ref).abs().max())
    max_err = max(max_err, err)
    print(f"phase1 production {len(qs)}x{len(ts)}: max|kernel-plain| = "
          f"{err}")
    if err:
        raise AssertionError("phase1 production: kernel != plain")
    cells = int(np.diff(qo).sum()) * int(np.diff(to).sum()) * P1_DUP
    # the wrapper's chain, twice; the kernel alone is timed in phase 5(b),
    # beside the run's other profiler sessions
    chain_ms = [_chain_ms(sw_packed.sw_allpairs, args, 16, 2,
                          P1_KERNEL_CALLS) for _ in range(2)]
    print(f"phase1 timing: {cells} true cells per call; wrapper chain ms "
          f"{chain_ms}; plain ms {p_ms} -> {cells / (p_ms * 1e-3):.6g} "
          f"cells/s")
    torch.cuda.synchronize()
    return {"max_abs_err": max_err, "pair_err": pair_err, "args": args,
            "chain_ms": min(chain_ms), "plain_ms": p_ms, "cells": cells,
            "bytes": _sw_bytes(np.diff(qo), sw_packed.A_PAD,
                               np.tile(np.diff(to), P1_DUP), 1)}


# ---------------------------------------------------------------- phase 2

def _cli(argv):
    """Run the port's CLI in this process; returns its exit code."""
    from spacepharer_tpu_torch import cli
    return cli.main(argv)


def _since(before, *names):
    """{name: the increase of the registry's total (logging.timings) since
    the snapshot `before`} of each named counter or span."""
    from spacepharer_tpu_torch.logging import timings
    now = timings()
    return {n: now.get(n, 0) - before.get(n, 0) for n in names}


def phase2(golden, tmp):
    from spacepharer_tpu_torch.logging import timings
    out = os.path.join(tmp, "p2", "result.tsv")
    os.makedirs(os.path.dirname(out))
    before = timings()
    t0 = time.perf_counter()
    rc = _cli(["predictmatch", _golden_query_path(golden),
               os.path.join(golden, "targets"),
               os.path.join(golden, "targets_rev"), out,
               os.path.join(tmp, "p2", "tmp"), "--use-tpu", "1", "-v", "1"])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"phase2: predictmatch exited {rc}")
    with open(out) as fh, open(os.path.join(golden, "result.tsv")) as gh:
        same = fh.read() == gh.read()
    n = _since(before, "sw_pairs_launches")["sw_pairs_launches"]
    print(f"phase2 golden via CLI --use-tpu 1: byte-identical={same}, "
          f"pair kernel launches {n}, wall {wall:.3f} s")
    if not same:
        raise AssertionError("phase2: result.tsv differs from the golden")
    if n <= 0:
        raise AssertionError("phase2: the kernel was never launched")
    return n


# ---------------------------------------------------------------- phase 3

def _mutate(seq, rate, rng):
    """Substitute ~rate of the ACGT positions, always by another base."""
    lut = np.full(256, 255, dtype=np.uint8)
    for i, b in enumerate(b"ACGT"):
        lut[b] = lut[b + 32] = i
    code = lut[seq]
    hit = (code != 255) & (rng.random(len(seq)) < rate)
    out = seq.copy()
    shift = rng.integers(1, 4, size=int(hit.sum())).astype(np.uint8)
    out[hit] = np.frombuffer(b"ACGT", np.uint8)[(code[hit] + shift) % 4]
    return out


def build_corpus(golden, tmp, seed):
    """Target and control SetDBs of COPIES 2%-mutated copies of each
    golden genome, and a query SetDB of the golden spacers plus SETS
    random sets of 3 spacers (25-45 nt), and a small one of its first
    SMALL_SETS random sets; saved once per run under tmp/<run>/ (a search
    persists its target index or masked target beside the DBs). Returns
    {run: [query, targets, targets_rev]} for the runs host, gpu, dense,
    dense_fresh and mesh (the whole query side), gate (never searched:
    phase 3(b) copies it) and host_small and dense_small."""
    from spacepharer_tpu_torch.io.setdb import (SetDB,
                                                build_setdb_from_spacers)
    from spacepharer_tpu_torch.io.spacer_formats import SpacerRecord
    rng = np.random.default_rng(seed)
    tdb, cdb, n_files, nt = mutated_targets(
        golden, os.path.join(tmp, "genomes"), COPIES, rng)

    qg = SetDB.load(_golden_query_path(golden))
    records = [SpacerRecord(qg.contig_header[i], qg.contig_accession[i],
                            qg.contig_seq(i).tobytes(),
                            int(qg.contig_to_set[i]))
               for i in range(qg.n_contigs)]
    names = list(qg.set_names)
    for si in range(SETS):
        fi = len(names)
        names.append(f"set{si:06d}.fas")
        for pi in range(3):
            n = int(rng.integers(25, 46))
            s = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]
            h = f"set{si:06d}_1_100_{pi + 1}_spacer_{pi * 61}_{n}"
            records.append(SpacerRecord(h, h, s.tobytes(), fi))
    qdb = build_setdb_from_spacers(records, names)
    n_small = len(qg.set_names) + SMALL_SETS
    qsmall = build_setdb_from_spacers(
        [r for r in records if r.file_idx < n_small], names[:n_small])
    paths = {}
    for run, q in (("host", qdb), ("gpu", qdb), ("dense", qdb),
                   ("dense_fresh", qdb), ("mesh", qdb), ("gate", qdb),
                   ("host_small", qsmall),
                   ("dense_small", qsmall)):
        paths[run] = []
        for name, db in (("query", q), ("targets", tdb),
                         ("targets_rev", cdb)):
            paths[run].append(os.path.join(tmp, run, name))
            db.save(paths[run][-1])
    print(f"phase3 corpus: {n_files} genomes, {nt} nt, {tdb.n_orfs} "
          f"target ORFs; {len(names)} spacer sets, {qdb.n_orfs} query ORFs")
    return paths


def mutated_targets(golden, fa_dir, copies, rng):
    """The target and control SetDBs of `copies` 2%-mutated copies of
    each golden genome (written as FASTAs under fa_dir), drawn from rng
    genome by genome; (targets, control, genomes, nucleotides)."""
    from spacepharer_tpu_torch.io.setdb import SetDB, build_setdb_from_fasta
    gdb = SetDB.load(os.path.join(golden, "targets"))
    os.makedirs(fa_dir)
    files, nt = [], 0
    for c in range(gdb.n_contigs):
        seq = gdb.contig_seq(c)
        acc = gdb.contig_accession[c]
        for ci in range(copies):
            mseq = _mutate(seq, 0.02, rng)
            path = os.path.join(fa_dir, f"{acc}_mut{ci:05d}.fna")
            with open(path, "wb") as fh:
                fh.write(f">{acc}_mut{ci:05d} mutated copy {ci}\n".encode()
                         + mseq.tobytes() + b"\n")
            files.append(path)
            nt += len(mseq)
    return (build_setdb_from_fasta(files),
            build_setdb_from_fasta(files, reverse_fragments=True),
            len(files), nt)


def _profile_words_per_load(args):
    """(The mean number of distinct 16-byte profile words a bulk warp's
    load asks for, over every (warp, column) of the pair kernel's first
    stripe, with the pairs in the order sw_pairs sorts them on the card
    (32 = each thread its own word; the count takes the place of bank
    conflicts where the bulk has no shared memory); the tail pairs, which
    come first and read a shared-memory table instead)."""
    import torch
    from spacepharer_tpu_torch.ops import sw_packed
    _, q_stripe, q_len, t_seqs, t_off, pair_q, pair_t = args
    key, need, stats = sw_packed.pair_keys_plain(
        q_len, t_off, pair_q, pair_t, sw_packed.PAIR_TAIL_WORK)
    n_tail = int(stats[0])
    order = sw_packed.pair_order(key, need)[0][n_tail:]
    pq, pt = pair_q.long(), pair_t.long()
    tl = (t_off[1:] - t_off[:-1])[pt][order]
    n_cols = int(tl.sum())
    if n_cols == 0:
        return 0.0, n_tail
    rep = torch.repeat_interleave(torch.arange(len(tl), device=tl.device),
                                  tl, output_size=n_cols)
    col = torch.arange(n_cols, device=tl.device) - (torch.cumsum(tl, 0)
                                                    - tl)[rep]
    letter = t_seqs[t_off[pt[order]][rep] + col].long() & 31
    word = q_stripe[pq[order]][rep] * 32 + letter
    request = (rep // 32) * (int(tl.max()) + 1) + col
    words = torch.unique(request * (int(word.max()) + 1) + word).numel()
    return words / torch.unique(request).numel(), n_tail


def _pair_work(args):
    """(bytes, true DP cells) of one sw_pairs call: the int8 profile rows
    within the length of each query the pairs name (32 letters each), the
    true letters of each target they name, the pair list (2 int32 a pair),
    each named query's stripe and length and target's offset, and an int32
    score a pair."""
    import torch
    _, _, q_len, _, t_off, pair_q, pair_t = args
    pq, pt = pair_q.long(), pair_t.long()
    t_lens = t_off[1:] - t_off[:-1]
    cells = int((q_len.long()[pq] * t_lens[pt]).sum())
    uq, ut = torch.unique(pq), torch.unique(pt)
    n_bytes = (32 * int(q_len.long()[uq].sum()) + int(t_lens[ut].sum())
               + 12 * uq.numel() + 8 * ut.numel() + 12 * pq.numel())
    return n_bytes, cells


def _pair_key_work(args):
    """(bytes, int32 operations) of one key pass over sw_pairs' pairs: the
    pair list, each named query's length and target's two offsets read
    once, an int16 key, an int64 scratch need a pair and the two counts
    written once; PAIR_KEY_OPS int32 operations a pair."""
    import torch
    _, _, _, _, _, pair_q, pair_t = args
    n = pair_q.numel()
    n_q, n_t = (torch.unique(x).numel() for x in (pair_q, pair_t))
    return 8 * n + 4 * n_q + 16 * n_t + 10 * n + 16, PAIR_KEY_OPS * n


def _profile_work(args):
    """(bytes, float64 operations, int32 operations) of one pair_profile
    call: its letters, query offsets and stripes, matrix and table read
    once and its int8 profile and flag written once; FLOAT64_OPS_PER_RESIDUE
    float64 operations per residue, and one int32 operation per window
    term and per profile entry (composition bias on)."""
    import torch
    letters, q_off, q_stripe, n_stripes, scores, expected, comp_bias = args
    total, n_q, alpha = letters.numel(), q_stripe.numel(), scores.shape[0]
    n_bytes = (total + 16 * n_q + 8 + 4 * alpha * alpha + 8 * alpha
               + n_stripes * 32 * 16 + 4)
    lens = (q_off[1:] - q_off[:-1]).long()
    n = torch.repeat_interleave(lens, lens, output_size=total)
    i = torch.arange(total, device=n.device) - torch.repeat_interleave(
        q_off[:-1], lens, output_size=total)
    win = torch.minimum(n, i + 20) - torch.clamp_min(i - 20, 0)
    f64 = FLOAT64_OPS_PER_RESIDUE * total if comp_bias else 0
    return n_bytes, f64, (int(win.sum()) if comp_bias else 0) + alpha * total


def _profile_bound(work, clock_hz):
    """(bound ms, "bytes" or "operations") of _profile_work's work: the
    larger of its bytes' time and its slower operation type's time."""
    n_bytes, f64, i32 = work
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(f64 / FLOAT64_OPS_PER_S, i32 / (SMS * INT32_LANES * clock_hz))
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _check_calls(calls, plain):
    """Hold each kernel call recorded on the main path, (args, output),
    against plain(*args) on the card, on the same inputs. Returns (max
    |kernel - plain|, the plain version's ms on the first call)."""
    import torch
    err, plain_ms = 0, []
    for args, kernel_out in calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = plain(*args)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
        if ref.shape != kernel_out.shape:
            raise AssertionError("kernel and plain output shapes differ")
        if ref.numel():
            err = max(err, int((kernel_out.int() - ref.int()).abs().max()))
    return err, plain_ms[0]


def _fresh_run(base, paths, run, *flags):
    """`predictmatch` through the CLI on paths[run] in a fresh process,
    as a user runs it: (wall s, result text, its 'Time for' lines)."""
    out = os.path.join(base, f"{run}.tsv")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "spacepharer_tpu_torch", "predictmatch",
         *paths[run], out, os.path.join(base, f"tmp_{run}"), *flags],
        cwd=REPO, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{run} run exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    with open(out) as fh:
        text = fh.read()
    return wall, text, [ln for ln in proc.stdout.splitlines()
                        if ln.startswith("Time for")]


def phase3(golden, tmp, seed, clock_hz):
    import torch
    from spacepharer_tpu_torch.logging import timings
    from spacepharer_tpu_torch.ops import sw_packed
    from spacepharer_tpu_torch.pipeline import predictmatch as pm

    base = os.path.join(tmp, "p3")
    paths = build_corpus(golden, base, seed)

    host_wall, host_text, host_stages = _fresh_run(base, paths, "host",
                                                   "--use-tpu", "0")

    # GPU engine forced on, in this process: count launches and the
    # candidate cells the device engine is handed, keep every pair-kernel
    # call's inputs and output for _check_calls, and split the scoring step
    cand_cells, calls, prof_calls, key_calls = [], [], [], []
    search_tpu = pm._search_tpu
    pairs = sw_packed.sw_pairs
    profile = sw_packed.pair_profile
    keys = sw_packed.pair_keys

    def _kept(*a):
        out = pairs(*a)
        calls.append((a[:9], out.clone()))
        return out

    def _kept_keys(*a):
        out = keys(*a)
        key_calls.append((a, tuple(x.clone() for x in out)))
        return out

    def _kept_profile(*a, comp_bias):
        out = profile(*a, comp_bias=comp_bias)
        prof_calls.append((a + (comp_bias,), out.clone()))
        return out

    def _counted(keys, t_aa, t_packed, cand, q_all, *a, **kw):
        q_lens = np.array([len(q_all[k]) for k in keys], dtype=np.int64)
        cand_cells.append(int(np.dot(np.repeat(q_lens, np.diff(cand[1])),
                                     np.diff(t_packed[1])[cand[0]])))
        return search_tpu(keys, t_aa, t_packed, cand, q_all, *a, **kw)

    gpu_out = os.path.join(base, "gpu.tsv")
    pm._search_tpu = _counted
    sw_packed.sw_pairs = _kept
    sw_packed.pair_keys = _kept_keys
    sw_packed.pair_profile = _kept_profile
    before = timings()
    split = {}
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(io.StringIO()), \
                _timed_calls(split, _search_tpu_split(pm)):
            rc = _cli(["predictmatch", *paths["gpu"], gpu_out,
                       os.path.join(base, "tmp_gpu"), "--use-tpu", "1",
                       "--prefilter-engine", "host", "-v", "1"])
    finally:
        pm._search_tpu = search_tpu
        sw_packed.sw_pairs = pairs
        sw_packed.pair_keys = keys
        sw_packed.pair_profile = profile
    gpu_wall = time.perf_counter() - t0
    launches = {k[:-len("_launches")]: v for k, v in _since(
        before, "sw_pairs_launches", "sw_pairs_keys_launches",
        "sw_allpairs_launches", "pair_profile_launches").items()}
    pair_cells = _since(before, "pair_cells")["pair_cells"]
    pair_split = _since(before, *PAIR_SPANS)
    after = timings()
    if rc != 0:
        raise AssertionError(f"phase3 GPU run exited {rc}")
    with open(gpu_out) as gh:
        gpu_text = gh.read()
    n_hits = sum(1 for ln in gpu_text.splitlines() if ln.startswith(">"))
    probe = pm._torch_probe and {k: v for k, v in pm._torch_probe[1].items()
                                 if k != "present"}
    print(f"phase3 host engine: wall {host_wall:.3f} s (fresh process, "
          f"own DB copy; "
          f"{'; '.join(host_stages)})")
    print(f"phase3 GPU engine: wall {gpu_wall:.3f} s (own DB copy; CUDA "
          f"initialised and the kernel built before it; search "
          f"{after.get('search', 0) - before.get('search', 0):.3f} s, "
          f"search_rev {after.get('search_rev', 0) - before.get('search_rev', 0):.3f} s); "
          f"candidate cells {cand_cells}; true cells on the card "
          f"{pair_cells}; launches {launches}; this process's torch "
          f"probe (s) {probe}")
    print("phase3 GPU engine " + _split_line(split))
    print(f"phase3 GPU engine scoring step over both searches (the "
          f"spans of device_pair_scores; each step ends when its work is "
          f"enqueued, but the read-back, which waits for the card): "
          + ", ".join(f"{k} {v:.4f} s" for k, v in pair_split.items()))
    print(f"phase3 texts identical={host_text == gpu_text}, "
          f"{len(gpu_text)} bytes, {n_hits} hit lines")
    if host_text != gpu_text:
        raise AssertionError("phase3: host and GPU texts differ")
    if (min(launches["sw_pairs"], launches["sw_pairs_keys"],
            launches["pair_profile"]) <= 0 or launches["sw_allpairs"]):
        raise AssertionError(f"phase3: launches {launches} (the pair "
                             "entry, its key pass and the profile kernel "
                             "alone must launch)")
    if split.get("bias", 0.0):
        raise AssertionError("phase3: the GPU engine built a bias on the "
                             "host")
    # every query of both searches: one profile call per search
    p_err, p_plain_ms = _check_calls(
        prof_calls, lambda *a: sw_packed.pair_profile_plain(*a)[0])
    print(f"phase3 profile kernel (bias and profile in one pass) on every "
          f"query of both searches ({[c[0][2].numel() for c in prof_calls]}"
          f" queries, {[c[0][0].numel() for c in prof_calls]} residues): "
          f"max|kernel-plain| = {p_err}; plain on the card "
          f"{p_plain_ms:.3f} ms")
    print(f"phase3 bias step over both searches: host _query_bias_i8 "
          f"{split.get('bias', 0.0):.4f} s; the "
          f"query profiles with their bias on the card "
          f"{pair_split['pair_profile']:.4f} s (enqueued, the profile "
          f"kernel's range check read back); _search_tpu "
          f"{split.get('_search_tpu', 0.0):.3f} s")
    if p_err:
        raise AssertionError("phase3: profile kernel output != plain")
    # every key pass of both searches: keys, scratch needs and counts
    k_err, k_plain_ms = 0, []
    for a, got in key_calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = sw_packed.pair_keys_plain(*a)
        torch.cuda.synchronize()
        k_plain_ms.append((time.perf_counter() - t0) * 1e3)
        for g, w in zip(got, want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                k_err = max(k_err, _max_diff(g, w), 1)
    print(f"phase3 pair key pass on every candidate pair of both searches "
          f"({[c[0][2].numel() for c in key_calls]} pairs, tail pairs "
          f"{[int(c[1][2][0]) for c in key_calls]}): keys, needs and counts "
          f"equal to pair_keys_plain's: {k_err == 0} (max|kernel-plain| = "
          f"{k_err}); plain on the card {k_plain_ms[0]:.3f} ms")
    if k_err or len(key_calls) != launches["sw_pairs_keys"]:
        raise AssertionError(f"phase3: key pass != plain ({k_err}) or "
                             f"{len(key_calls)} key calls for "
                             f"{launches['sw_pairs_keys']} launches")
    # every candidate pair of both searches
    err, plain_ms = _check_calls(calls, sw_packed.sw_pairs_plain)
    print(f"phase3 pair kernel on every candidate pair of both searches "
          f"({[c[0][5].numel() for c in calls]} pairs): max|kernel-plain| "
          f"= {err}; plain on the card {plain_ms:.3f} ms")
    if err:
        raise AssertionError("phase3: pair kernel output != plain")
    _print_gate(paths["host"])
    return {"launches": launches, "host_wall": host_wall,
            "gpu_wall": gpu_wall, "pair_cells": pair_cells,
            "max_abs_err": err, "plain_ms": plain_ms,
            "keys": {"max_abs_err": k_err, "plain_ms": k_plain_ms[0]},
            "pair_args": calls[0][0][:9], "base": base, "paths": paths,
            "profile": {"max_abs_err": p_err, "plain_ms": p_plain_ms,
                        "args": prof_calls[0][0]},
            "host_text": host_text, "cand_cells": cand_cells}


def phase3_device_times(p3, clock_hz):
    """Phase 3's two kernels timed at the first search's inputs, each
    beside its bound: the profile step's device time (every kernel and
    memset pair_profile puts on the card: the bound counts the whole
    profile written once) and the pair entry's (its key pass and the
    kernel that scores the tail and the bulk), by torch.profiler. Run
    inside phase 4(b), beside its other profiler sessions. Fills in p3's
    ms and bounds."""
    from spacepharer_tpu_torch.ops import sw_packed
    p_args = p3["profile"]["args"]
    p_split = device_split(sw_packed.pair_profile, p_args, P3_PROFILE_CALLS,
                           ("pair_profile_kernel",))[0]
    p_ms = named_ms(p_split, None)
    p_bound = _profile_bound(_profile_work(p_args), clock_hz)
    print(f"phase3 profile step, first search: device time {p_ms:.6f} ms "
          f"(torch.profiler, {P3_PROFILE_CALLS} calls: "
          + ", ".join(f"{k} {v:.6f}" for k, v in sorted(p_split.items()))
          + f"), bound {p_bound[0]:.6f} ms ({p_bound[1]}), share "
          f"{p_bound[0] / p_ms:.4f}")
    args, (go, ge) = p3["pair_args"][:7], p3["pair_args"][7:9]
    k_split = device_split(sw_packed.sw_pairs, args + (go, ge),
                           P3_PAIR_CALLS, PAIR_FUNCTIONS)[0]
    k_ms = named_ms(k_split, PAIR_FUNCTIONS)
    n_bytes, cells = _pair_work(args)
    bound = _sw_bound(n_bytes, cells, clock_hz)
    key_bound = _bound(*_pair_key_work(args), SMS * INT32_LANES * clock_hz)
    words, n_tail = _profile_words_per_load(args)
    t_lens = args[4][1:] - args[4][:-1]
    print(f"phase3 pair kernels, first search: {cells} true cells, "
          f"{args[5].numel()} pairs ({n_tail} in the tail), longest target "
          f"{int(t_lens[args[6].long()].max())}: device time "
          f"{k_ms:.6f} ms ({' + '.join(PAIR_FUNCTIONS)}; torch.profiler, "
          f"{P3_PAIR_CALLS} calls; the wrapper's device work: "
          + ", ".join(f"{k} {v:.6f}" for k, v in sorted(k_split.items()))
          + f"; the whole call {sum(k_split.values()):.6f}) -> "
          f"{cells / (k_ms * 1e-3):.6g} cells/s, bound "
          f"{bound[0]:.6f} ms ({bound[1]}), share {bound[0] / k_ms:.4f} "
          f"(sw_pairs_kernel alone "
          f"{bound[0] / k_split['sw_pairs_kernel']:.4f}; the key pass's own "
          f"bound {key_bound[0]:.6f} ms ({key_bound[1]}), share "
          f"{key_bound[0] / k_split['pair_keys_kernel']:.4f}); distinct "
          f"16-byte profile words per bulk warp load {words:.3f} of 32")
    p3["profile"].update(ms=p_ms, bound=p_bound)
    p3.update(ms=k_split["sw_pairs_kernel"], bound=bound)
    p3["keys"].update(ms=k_split["pair_keys_kernel"], bound=key_bound)


@contextlib.contextmanager
def _timed_calls(spent, targets):
    """Wrap each (module, name, key) of targets so that its calls add
    their seconds to spent[key]; the originals come back on exit."""
    orig = []
    for mod, name, key in targets:
        fn = getattr(mod, name)
        orig.append((mod, name, fn))

        def run(*a, _fn=fn, _key=key, **kw):
            t = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                spent[_key] = spent.get(_key, 0.0) + time.perf_counter() - t
        setattr(mod, name, run)
    try:
        yield spent
    finally:
        for mod, name, fn in reversed(orig):
            setattr(mod, name, fn)


def _search_tpu_split(pm):
    """_search_tpu and its four steps, for _timed_calls."""
    return ((pm, "_search_tpu", "_search_tpu"),
            (pm, "_query_bias_i8", "bias"),
            (pm, "_candidate_scores", "scoring"),
            (pm, "_evalue_screen", "screen"),
            (pm, "_align_survivors", "survivor alignment"))


def _split_line(split):
    """'_search_tpu T s over both searches: bias b s, ...' of a split."""
    total = split.get("_search_tpu", 0.0)
    parts = [(k, split.get(k, 0.0)) for k in
             ("bias", "scoring", "screen", "survivor alignment")]
    return (f"_search_tpu {total:.3f} s over both searches: "
            + ", ".join(f"{k} {v:.3f} s" for k, v in parts)
            + f", the rest {total - sum(v for _, v in parts):.3f} s")


def _gate_shape(paths):
    """(query k-mers, target residues) of a corpus, as the auto
    prefilter gate counts them."""
    from spacepharer_tpu_torch.io.setdb import SetDB
    from spacepharer_tpu_torch.ops.prefilter import PrefilterParams
    span = PrefilterParams().pattern_span
    q_lens = np.diff(SetDB.load(paths[0]).orf_aa_offsets)
    return (int(np.maximum(q_lens - span + 1, 0).sum()),
            int(np.diff(SetDB.load(paths[1]).orf_aa_offsets).sum()))


def _print_gate(paths):
    """The auto prefilter gate's decision for the corpus's shape, as a
    fresh search of it would ask (no persisted index)."""
    from spacepharer_tpu_torch.pipeline import predictmatch as pm
    nk, t_res = _gate_shape(paths)
    viable = pm.dense_prefilter_viable(nk, t_res, has_idx=False)
    print(f"phase3 auto prefilter gate for {nk} k-mers x {t_res} target "
          f"residues (fresh index): {'dense' if viable else 'host'}")


def host_walk_probe(query, targets):
    """Print, as JSON, the host batch walk's two costs in this fresh
    process: the postings build of the target (no persisted index) and
    the native walk of every query k-mer, in search_setdbs' chunks."""
    from spacepharer_tpu_torch.io.setdb import SetDB
    from spacepharer_tpu_torch.ops.matrices import load_matrix
    from spacepharer_tpu_torch.ops.prefilter import (PrefilterParams,
                                                     build_target_index,
                                                     prefilter_query_batch)
    from spacepharer_tpu_torch.pipeline import predictmatch as pm
    params = PrefilterParams()
    t_flat, t_off = SetDB.load(targets).orf_aa_encoded()
    t_aa = [t_flat[t_off[i]:t_off[i + 1]] for i in range(len(t_off) - 1)]
    q_flat, q_off = SetDB.load(query).orf_aa_encoded()
    q_all = [q_flat[q_off[i]:q_off[i + 1]] for i in range(len(q_off) - 1)]
    seed_m = load_matrix(params.seed_matrix, 8.0)
    ungapped_m = load_matrix(params.ungapped_matrix, 2.0)
    t0 = time.perf_counter()
    index = build_target_index(t_aa, params, packed=(t_flat, t_off))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for lo in range(0, len(q_all), pm._BATCH_CHUNK):
        hi = min(lo + pm._BATCH_CHUNK, len(q_all))
        prefilter_query_batch(q_all[lo:hi], index, params, seed_m,
                              ungapped_m, packed=(q_flat, q_off[lo:hi + 1]),
                              as_arrays=True)
    walk_s = time.perf_counter() - t0
    nk = int(np.maximum(np.diff(q_off) - params.pattern_span + 1, 0).sum())
    print(json.dumps({"t_res": int(t_off[-1]), "build_s": build_s,
                      "nk": nk, "walk_s": walk_s}))


def auto_run(threshold, argv):
    """The CLI with `auto` engine gates, the scoring gate's threshold set
    to `threshold` candidate cells (0: the GPU engine for every search
    with candidates; 1e30: the host engine). The control search forks
    onto the host engine either way, as under `auto` in the product."""
    from spacepharer_tpu_torch import cli
    from spacepharer_tpu_torch.pipeline import predictmatch as pm
    pm._DEVICE_CELLS_THRESHOLD = threshold
    return cli.main(argv)


def _gate_queries(src, dest, copies):
    """Save at dest the query SetDB at src with each spacer set repeated
    `copies` times (copy c's sets and spacers renamed with a c suffix):
    every search does the same work `copies` times over."""
    from spacepharer_tpu_torch.io.setdb import SetDB, build_setdb_from_spacers
    from spacepharer_tpu_torch.io.spacer_formats import SpacerRecord
    q = SetDB.load(src)
    names = list(q.set_names)
    records, all_names = [], []
    for c in range(copies):
        all_names += [f"c{c}_{n}" for n in names]
        records += [SpacerRecord(f"{q.contig_header[i]}_c{c}",
                                 f"{q.contig_accession[i]}_c{c}",
                                 q.contig_seq(i).tobytes(),
                                 int(q.contig_to_set[i]) + c * len(names))
                    for i in range(q.n_contigs)]
    build_setdb_from_spacers(records, all_names).save(dest)


def _forced_run(src, dest, engine, *flags):
    """predictmatch in a fresh process on a fresh copy (src copied to
    dest: no persisted index, no cached stage) with `auto` gates and the
    host prefilter, the scoring engine forced to engine ("gpu" or
    "host") through auto_run: (wall s, search stage s, text, [(candidate
    cells, the engine the search took)], None or the torch probe's
    (thread s, the search's wait s))."""
    shutil.copytree(src, dest)
    argv = ["predictmatch", *(os.path.join(dest, n) for n in
                              ("query", "targets", "targets_rev")),
            os.path.join(dest, "result.tsv"), os.path.join(dest, "tmp"),
            "--prefilter-engine", "host", *flags]
    code = (f"import sys, chip_smoke; sys.exit(chip_smoke.auto_run("
            f"{0.0 if engine == 'gpu' else 1e30!r}, {argv!r}))")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{dest} exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    search = re.search(r"Time for search: ([0-9.]+)s", proc.stdout)
    took = re.findall(r"candidate cells (\d+) -> (\w+) scoring engine",
                      proc.stderr)
    probe = re.search(r"torch probe: .* ([0-9.]+) s on a thread; the "
                      r"search waited ([0-9.]+) s", proc.stderr)
    with open(os.path.join(dest, "result.tsv")) as fh:
        text = fh.read()
    shutil.rmtree(dest)
    return (wall, float(search.group(1)), text, took,
            probe and tuple(float(v) for v in probe.groups()))


def _shape(shape):
    """A phase 3(b) shape's label: its query-side copies, or the target
    axis' point."""
    return (f"x{shape}" if shape != "t"
            else f"target-axis x{GATE_TARGET_COPIES // COPIES}")


def phase3_gates(p3, golden, seed):
    """(b): the auto gates' host terms and the scoring engine's
    break-even, on the card's host. The host walk's postings build and
    k-mer walk in GATE_RUNS fresh processes (medians); then the search
    stage of the GPU engine and of the host engine, both under `auto`
    with the host prefilter (each forks its control search onto the
    host), GATE_SHAPE_RUNS alternating fresh runs per engine and shape on
    fresh DB copies: phase 3's corpus and its query side GATE_BIG_COPIES
    and GATE_HUGE_COPIES times over (the same target), and the target
    axis' point, phase 3's query side against GATE_TARGET_COPIES mutated
    copies of each golden genome. Every text must equal the first host
    text of its shape. The break-even is where the two engines'
    least-squares lines through the query-side medians cross, in
    candidate cells; the target-axis point's medians print beside the
    lines' predictions for its candidate cells."""
    from spacepharer_tpu_torch.pipeline import predictmatch as pm
    t_phase = time.perf_counter()
    base = os.path.join(p3["base"], "gates")
    pristine = {1: p3["paths"]["gate"][0].rsplit(os.sep, 1)[0]}
    for copies in (GATE_BIG_COPIES, GATE_HUGE_COPIES):
        big = os.path.join(base, f"x{copies}")
        shutil.copytree(pristine[1], big,
                        ignore=shutil.ignore_patterns("query"))
        _gate_queries(os.path.join(pristine[1], "query"),
                      os.path.join(big, "query"), copies)
        pristine[copies] = big
    t_dir = os.path.join(base, "t")
    shutil.copytree(pristine[1], t_dir,
                    ignore=shutil.ignore_patterns("targets*"))
    genomes = os.path.join(base, "t_genomes")
    tdb, cdb, n_files, nt = mutated_targets(
        golden, genomes, GATE_TARGET_COPIES, np.random.default_rng(seed))
    tdb.save(os.path.join(t_dir, "targets"))
    cdb.save(os.path.join(t_dir, "targets_rev"))
    shutil.rmtree(genomes)
    pristine["t"] = t_dir
    print(f"phase3 gate target-axis corpus: {n_files} genomes, {nt} nt, "
          f"{tdb.n_orfs} target ORFs, {int(tdb.orf_aa_offsets[-1])} "
          f"residues (built in {time.perf_counter() - t_phase:.1f} s)")

    probes = []
    for _ in range(GATE_RUNS):
        proc = subprocess.run(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.host_walk_probe("
             f"{p3['paths']['gate'][0]!r}, {p3['paths']['gate'][1]!r})"],
            cwd=REPO, capture_output=True, text=True)
        if proc.returncode != 0:
            raise AssertionError(f"phase3 host walk probe exited "
                                 f"{proc.returncode}:\n{proc.stderr[-4000:]}")
        probes.append(json.loads(proc.stdout.splitlines()[-1]))
    per_res = float(np.median([p["build_s"] / p["t_res"] for p in probes]))
    per_kmer = float(np.median([p["walk_s"] / p["nk"] for p in probes]))
    print(f"phase3 host walk, {GATE_RUNS} fresh processes "
          f"({probes[0]['t_res']} residues, {probes[0]['nk']} k-mers): "
          f"postings build s {[round(p['build_s'], 3) for p in probes]}, "
          f"walk s {[round(p['walk_s'], 3) for p in probes]}; fit "
          f"_HOST_POSTINGS_S_PER_RES {per_res:.6g} (in the code "
          f"{pm._HOST_POSTINGS_S_PER_RES:.6g}), _HOST_WALK_S_PER_KMER "
          f"{per_kmer:.6g} (in the code {pm._HOST_WALK_S_PER_KMER:.6g})")

    proc = subprocess.run(
        [sys.executable, "-c", "import time; t0 = time.perf_counter(); "
         "import torch; t1 = time.perf_counter(); "
         "torch.zeros(1, device='cuda'); torch.cuda.synchronize(); "
         "print(t1 - t0, time.perf_counter() - t1)"],
        cwd=REPO, capture_output=True, text=True, check=True)
    imp, ctx = (float(v) for v in proc.stdout.split())
    print(f"phase3 a fresh process's first touch of the card: import torch "
          f"{imp:.3f} s, then a CUDA context and one tensor on the card "
          f"{ctx:.3f} s")

    cells_1 = p3["cand_cells"][0]
    runs = {(c, e): [] for c in pristine for e in ("gpu", "host")}
    texts, cells = {}, {}
    for rep in range(max(GATE_SHAPE_RUNS.values())):
        for shape, src in pristine.items():
            if rep >= GATE_SHAPE_RUNS[shape]:
                continue
            order = ("gpu", "host") if rep % 2 == 0 else ("host", "gpu")
            for engine in order:
                wall, search, text, took, probe = _forced_run(
                    src, os.path.join(base, f"{shape}_{engine}_{rep}"),
                    engine)
                want = "device" if engine == "gpu" else "host"
                if not took or took[0][1] != want:
                    raise AssertionError(f"phase3 gate run {_shape(shape)} "
                                         f"{engine}: engine {took}")
                if texts.setdefault(shape, text) != text:
                    raise AssertionError(f"phase3 gate run {_shape(shape)} "
                                         f"{engine}: text differs")
                cells.setdefault(shape, int(took[0][0]))
                runs[(shape, engine)].append((wall, search, probe))
    if texts[1] != p3["host_text"]:
        raise AssertionError("phase3 gate runs: text differs from phase 3's")
    if cells[1] != cells_1:
        raise AssertionError(f"phase3 gate runs: {cells[1]} candidate "
                             f"cells, phase 3 counted {cells_1}")
    med = {}
    for (shape, engine), rr in runs.items():
        med[(shape, engine)] = float(np.median([r[1] for r in rr]))
        print(f"phase3 gate {_shape(shape)} ({cells[shape]} candidate cells) "
              f"{engine} engine: search s "
              f"{[round(r[1], 3) for r in rr]}, walls s "
              f"{[round(r[0], 3) for r in rr]}; median search "
              f"{med[(shape, engine)]:.3f} s"
              + (f"; torch probe (thread s, the search's wait s) "
                 f"{[r[2] for r in rr]}" if engine == "gpu" else ""))
    query_side = [c for c in pristine if c != "t"]
    x = np.array([cells[c] for c in query_side], dtype=np.float64)
    lines = {e: np.polyfit(x, [med[(c, e)] for c in query_side], 1)
             for e in ("gpu", "host")}
    (bg, ag), (bh, ah) = lines["gpu"], lines["host"]
    cross = (ag - ah) / (bh - bg) if bh != bg else float("inf")
    inside = bool(x.min() <= cross <= x.max())
    wins = [med[(c, "gpu")] < med[(c, "host")] for c in query_side]
    print(f"phase3 gate fit over the {len(x)} query-side shapes (least "
          f"squares through the medians): search s = a + b x cells, GPU "
          f"engine a {ag:.6g} b {bg:.6g}, host engine a {ah:.6g} b "
          f"{bh:.6g}; the lines cross at {cross:.6g} candidate cells "
          f"({'inside' if inside else 'outside'} the measured "
          f"{x.min():.6g}-{x.max():.6g}; the GPU engine "
          f"{'faster' if bh > bg else 'slower'} per cell); the GPU engine "
          f"won at {sum(wins)} of {len(wins)} shapes; _DEVICE_CELLS_THRESHOLD"
          f" in the code {pm._DEVICE_CELLS_THRESHOLD:.6g}")
    ct = cells["t"]
    engages = pm.device_scoring_engages(None, None, ct, lambda: True)
    print(f"phase3 gate target axis (x{GATE_TARGET_COPIES // COPIES} target "
          f"genomes, {ct} candidate cells): median search GPU engine "
          f"{med[('t', 'gpu')]:.3f} s (the line predicts "
          f"{ag + bg * ct:.3f}), host engine {med[('t', 'host')]:.3f} s "
          f"(the line predicts {ah + bh * ct:.3f}); the GPU engine "
          f"{'won' if med[('t', 'gpu')] < med[('t', 'host')] else 'lost'}; "
          f"auto at this point: the "
          f"{'GPU' if engages else 'host'} engine")
    print(f"phase3 (b) in {time.perf_counter() - t_phase:.1f} s")

    return {"post_s_per_res": per_res, "walk_s_per_kmer": per_kmer,
            "pristine": pristine}


# ---------------------------------------------------------------- phase 4

def _test_module(name):
    """tests/<name>.py, loaded by path: phases 4 and 5 run its `cuda`
    cases."""
    import importlib.util
    tests = os.path.join(REPO, "tests")
    if tests not in sys.path:       # test modules import each other
        sys.path.insert(0, tests)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tests", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dense_tests():
    return _test_module("test_torch_prefilter_dense")


def _hit_err(a, b, positions):
    """The entries at which two passes' hits (gi, gj), each sorted as one
    key gi * positions + gj, differ (0: the same hits); hits of different
    numbers fail."""
    import torch

    def key(out):
        return torch.sort(out[0].long() * positions + out[1].long()).values

    ka, kb = key(a), key(b)
    if ka.numel() != kb.numel():
        raise AssertionError(f"{ka.numel()} hits against {kb.numel()}")
    return int((ka != kb).sum())


def _dense_check(name, inputs, where="phase4"):
    """B2's pass on one chunk, the kernel (chunk_hits into the device's
    hit buffer, and into a buffer of half the hits, which runs the chunk
    again) against its plain version on the same card tensors. Returns
    (max error, hits)."""
    from spacepharer_tpu_torch.ops import prefilter_dense as pd
    dev = inputs[0].device
    compacted = pd.compact_rows(inputs[0], inputs[1])
    got = pd.chunk_hits(compacted, *inputs[2:], pd.hit_buffer(dev))
    n = got[0].numel()
    gi, gj, cursor = pd.new_hit_buffer(n, dev)
    pd.prefilter_dense_hits_plain(compacted, *inputs[2:], gi, gj, cursor)
    positions = inputs[3].numel()
    err = max(_hit_err(got, (gi, gj), positions),
              _hit_err(pd.chunk_hits(compacted, *inputs[2:],
                                     pd.new_hit_buffer(n // 2, dev)),
                       (gi, gj), positions),
              abs(int(cursor.item()) - n))
    print(f"{where} {name}: {inputs[0].shape[0]} rows x {positions} "
          f"positions, {n} hits; kernel vs plain max err {err} (also run "
          f"again from a buffer of {n // 2})")
    if err:
        raise AssertionError(f"{where} {name}: kernel != plain")
    return err, n


def phase4_cases(dev):
    """(a): the `cuda` cases of the dense prefilter's tests (the test
    corpora, a zero-hit input, a multi-chunk target with X letters and
    ORF boundaries): the pass against its plain version, and match_pairs
    with small chunk and buffer bounds against the numpy oracle. Returns
    the max error."""
    from spacepharer_tpu_torch.ops import prefilter_dense as pd
    tests = _dense_tests()
    worst = 0
    for name in tests.CUDA_CASES:
        params, seed_m, batch, flat, bval = tests.cuda_case(name)
        thr = params.kmer_threshold()
        err, n = _dense_check(name, pd.dense_inputs(
            batch, flat, bval, seed_m.scores, thr, dev))
        worst = max(worst, err)
        if (n == 0) != (name == "zero_hits"):
            raise AssertionError(f"phase4 {name}: {n} hits")
        got, (launched, reruns) = tests.match_pairs_small_bounds(
            batch, flat, bval, seed_m.scores, thr)
        same = got == tests.pairs(*pd.match_pairs_numpy(
            batch, flat, bval, seed_m.scores, thr))
        print(f"phase4 {name}: match_pairs on the card ({launched} "
              f"launches, {reruns} chunks run again) equals the numpy "
              f"oracle: {same}")
        if not same:
            raise AssertionError(f"phase4 {name}: match_pairs != oracle")
    return worst


def phase4_stream_cases():
    """(a) continued: the stream kernels (csrc/prefilter_streams.cu)
    against their plain versions on the card, on the dense pass's own
    hits of every `cuda` case with six offsets and on the random hits of
    tests/test_torch_prefilter_streams.py (keys wider than the bit
    budget, pad hits, no hits, repeated halves among them) and on its seam
    cases (a run across many blocks of the run kernels, every query half,
    one half, heavy score ties, one hit, every hit dropped). Returns the
    largest difference."""
    import torch
    from spacepharer_tpu_torch.ops import prefilter_dense as pd
    tests = _test_module("test_torch_prefilter_streams")
    err = 0
    for name in tests.SIX_OFFSET_CASES:
        params, scores, batch, flat, starts, bval = tests.card_case(name)
        gi, gj = pd.match_pairs(batch, flat, bval, scores,
                                params.kmer_threshold(), device="cuda")
        e, launched = tests.card_streams_check(batch, gi, gj, flat, starts,
                                               scores)
        print(f"phase4 streams {name}: {gi.numel()} hits; kernels vs plain "
              f"max err {e}; launches {launched}")
        err = max(err, e)
    key_bits = pd.KEY_BITS
    try:
        for name, kw in (("random", {}), ("wide_keys", dict(n_queries=30)),
                         ("pad_hits", dict(pad_hits=300)),
                         ("no_hits", dict(n_hits=0)),
                         ("repeated_halves", dict(alphabet=2,
                                                  n_queries=20))):
            pd.KEY_BITS = 0 if name == "wide_keys" else key_bits
            batch, gi, gj, flat, starts, seed_m = tests.stream_case(7, **kw)
            e, launched = tests.card_streams_check(
                batch, torch.from_numpy(gi.astype(np.int32)).cuda(),
                torch.from_numpy(gj.astype(np.int64)).cuda(), flat, starts,
                seed_m.scores)
            print(f"phase4 streams random {name}: {len(gi)} hits; kernels "
                  f"vs plain max err {e}; launches {launched}")
            err = max(err, e)
        for name in tests.SEAM_CASES:
            pd.KEY_BITS = key_bits
            batch, gi, gj, flat, starts, scores, pd.KEY_BITS = (
                tests.seam_case(name))
            e, launched = tests.card_streams_check(
                batch, torch.from_numpy(gi.astype(np.int32)).cuda(),
                torch.from_numpy(gj.astype(np.int64)).cuda(), flat, starts,
                scores)
            print(f"phase4 streams seam {name}: {len(gi)} hits; kernels vs "
                  f"plain max err {e}; launches {launched}")
            err = max(err, e)
    finally:
        pd.KEY_BITS = key_bits
    if err:
        raise AssertionError("phase4 streams: kernel != plain")
    return err


def _max_diff(a, b):
    """max |a - b| of two integer tensors of one shape (0 when empty);
    tensors of different shapes fail."""
    if a.shape != b.shape:
        raise AssertionError(f"phase4 streams: shapes {tuple(a.shape)} and "
                             f"{tuple(b.shape)} differ")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def phase4_streams(batch, gi, gj, flat, starts, scores):
    """(b) continued: the stream kernels at the production shape, on the
    dense pass's own hits (gi, gj on the card), each against its plain
    version on the same card tensors (max error 0) and timed alone by
    torch.profiler (device_ms: each wrapper's kernels' device time), with
    the sort (torch.sort) timed apart, each kernel's bound in bytes (each
    input that it reads read once, each output written once) at
    HBM_BYTES_PER_S and the rank tables' library yardstick
    (_rank_sort_ms)."""
    import torch
    from spacepharer_tpu_torch.ops import prefilter_dense as pd
    q_flat, offsets, t, ts, seed, qs, seq_bits, narrow = pd.stream_inputs(
        batch, flat, starts, scores, gi.device)
    n_keys = len(batch.keys)
    r_ms, (slot_of, tables) = device_ms(
        pd.stream_rank_tables, (q_flat, offsets, gi, batch.n_rows, seed),
        STREAM_FUNCTIONS["ranks"], P4_KERNEL_CALLS)
    key_args = (gi, gj, q_flat, offsets, batch.n_rows, t, ts, slot_of,
                tables, seq_bits, narrow)
    k_ms, keys = device_ms(pd.stream_keys, key_args,
                           STREAM_FUNCTIONS["keys"], P4_KERNEL_CALLS)
    sort_ms, (perm, sorted_key) = device_ms(
        pd.sort_keys, (keys[0], keys[1], narrow), None, P4_KERNEL_CALLS)
    run_args = (perm, *keys[:3], gi, qs, n_keys)
    u_ms, runs = device_ms(pd.stream_runs,
                           run_args + (sorted_key, seq_bits, narrow),
                           STREAM_FUNCTIONS["runs"], P4_KERNEL_CALLS)
    plain, plain_ms = {}, {}
    for name, fn, args in (
            ("ranks", pd.stream_rank_tables_plain,
             (q_flat, offsets, gi, batch.n_rows, seed)),
            ("keys", pd.stream_keys_plain, key_args),
            ("runs", pd.stream_runs_plain, run_args)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain[name] = fn(*args)
        torch.cuda.synchronize()
        plain_ms[name] = (time.perf_counter() - t0) * 1e3
    n_runs = int(plain["runs"][3])
    errs = {"ranks": max(_max_diff(slot_of, plain["ranks"][0]),
                         _max_diff(tables, plain["ranks"][1])),
            "keys": max(_max_diff(a, b) for a, b in zip(keys, plain["keys"])),
            "runs": max([_max_diff(runs[i][:n_runs], plain["runs"][i])
                         for i in (0, 1)]
                        + [_max_diff(runs[i], plain["runs"][i])
                           for i in (2, 3)])}
    n = gi.numel()
    # the runs read the sorted keys, the order and the positions; the rows
    # and sequences only when the keys do not carry them
    work = {"ranks": _nbytes(gi, q_flat, seed, slot_of, tables)
            + 2 * 4 * pd.N_QUERY_HALVES,            # flags, list of halves
            "keys": _nbytes(gi, gj, q_flat, t, ts, slot_of, tables, *keys),
            "runs": _nbytes(sorted_key, perm, keys[2], qs)
            + (0 if narrow else _nbytes(keys[1], gi)) + 6 * n_runs
            + _nbytes(runs[2], runs[3])}             # m_t, m_d; bounds
    library = {"ranks": _rank_sort_ms(seed, slot_of), "keys": None,
               "runs": None}
    out = {}
    for name, ms in (("ranks", r_ms), ("keys", k_ms), ("runs", u_ms)):
        bound, bound_by = _bound(work[name], 0, INT8_OPS_PER_S)
        out[name] = (errs[name], ms, plain_ms[name], (bound, bound_by),
                     library[name])
        lib = ("none" if library[name] is None else
               f"{library[name]:.4f} ms (torch.sort of the [{tables.shape[0]}"
               f", {pd.N_HALF}] half scores, stable, the sort alone)")
        print(f"phase4 production streams {name}: device time {ms:.4f} ms "
              f"(torch.profiler, {STREAM_FUNCTIONS[name]}), "
              f"bound {bound:.6g} ms ({bound_by}, {work[name]} bytes), share "
              f"{bound / ms:.4f}; plain on the card {plain_ms[name]:.3f} ms; "
              f"library {lib}; max|kernel-plain| = {errs[name]}")
    # one sort of the packed keys reads them and writes them and their
    # indices (two stable sorts and two gathers when they do not fit)
    sort_bytes = 24 * n
    print(f"phase4 production streams: {n} hits, {tables.shape[0]} distinct "
          f"query halves, {n_runs} stream entries ({n_keys} query keys), "
          f"keys {'packed in 63 bits' if narrow else 'in two sorts'}; sort "
          f"(torch.sort) {sort_ms:.4f} ms (one sort's {sort_bytes} bytes at "
          f"{HBM_BYTES_PER_S:.3g} B/s: "
          f"{sort_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms); the rebuild's "
          f"kernels and sort {r_ms + k_ms + sort_ms + u_ms:.4f} ms")
    if any(errs.values()):
        raise AssertionError("phase4 production streams: kernel != plain")
    return out


def _rank_sort_ms(seed, slot_of):
    """Mean device ms (torch.profiler, one warm-up call) of the one PyTorch
    call that
    orders every listed query half's 8,000 target half-codes: torch.sort
    of the negated [n_uniq, 8000] score matrix along its rows, stable, the
    sort alone (no score build, no scatter of the ranks). The rank tables'
    library yardstick: the port never calls it."""
    import torch
    from spacepharer_tpu_torch.ops import prefilter_dense as pd
    uniq = torch.nonzero(slot_of >= 0).flatten()
    c = torch.arange(pd.N_HALF, device=seed.device)
    base = pd.X_IDX + 1
    halves = (uniq // (base * base), uniq // base % base, uniq % base)
    neg = -sum(seed[h][:, col] for h, col in zip(
        halves, (c // 400, c // 20 % 20, c % 20)))
    ms, _ = device_ms(lambda x: torch.sort(x, dim=1, stable=True),
                      (neg,), None, P4_KERNEL_CALLS)
    return ms


def production_dense_inputs(paths):
    """(params, seed matrix, query ORFs, keys, batch, masked flat target,
    its starts, boundary validity): phase 4(b)'s dense-pass inputs from
    phase 3's DBs (paths: [query, targets, targets_rev]), the query ORFs
    of the first key chunk (MAX_Q_ROWS residues, as the port chunks them)
    against the whole masked target."""
    from spacepharer_tpu_torch.io.setdb import SetDB
    from spacepharer_tpu_torch.ops import prefilter_dense as pd
    from spacepharer_tpu_torch.ops.bias import local_aa_bias_batch
    from spacepharer_tpu_torch.ops.matrices import load_matrix
    from spacepharer_tpu_torch.ops.prefilter import (PrefilterParams,
                                                     build_masked_flat,
                                                     load_masked_flat)
    params = PrefilterParams()
    seed_m = load_matrix(params.seed_matrix, 8.0)
    qdb = SetDB.load(paths[0])
    qf, qo = qdb.orf_aa_encoded()
    q_all = [qf[qo[k]:qo[k + 1]] for k in range(qdb.n_orfs)]
    keys, rows = [], 0
    for k in range(len(q_all)):          # one query chunk, as the port
        if keys and rows + len(q_all[k]) > pd.MAX_Q_ROWS:
            break
        keys.append(k)
        rows += len(q_all[k])
    batch = pd.build_query_batch(q_all, keys,
                                 local_aa_bias_batch(q_all, seed_m), params)
    masked = load_masked_flat(paths[1], params)
    if masked is None:
        tdb = SetDB.load(paths[1])
        tf, to = tdb.orf_aa_encoded()
        masked = build_masked_flat(None, params, packed=(tf, to))
    flat = np.ascontiguousarray(masked[0])
    starts = np.asarray(masked[1], dtype=np.int64)
    return (params, seed_m, q_all, keys, batch, flat, starts,
            pd.target_boundary_valid(starts, batch.span))


def phase4_production(dev, p3, clock_hz):
    """(b): phase 3's query k-mer rows (one chunk) x its whole masked
    target, exact against plain (one plain call each) and timed; and two
    of the gate's constants."""
    import torch
    from spacepharer_tpu_torch.ops import prefilter_dense as pd
    params, seed_m, q_all, keys, batch, flat, starts, bval = (
        production_dense_inputs(p3["paths"]["host"]))
    kmer_thr = params.kmer_threshold()
    inputs = pd.dense_inputs(batch, flat, bval, seed_m.scores, kmer_thr, dev)
    cells = batch.n_rows * len(flat)
    print(f"phase4 production: {len(keys)} query ORFs, {batch.n_rows} "
          f"k-mer rows ({int(batch.kmer_valid.sum())} valid) x {len(flat)} "
          f"target residues = {cells} dense cells")

    t0 = time.perf_counter()
    compacted = pd.compact_rows(inputs[0], inputs[1])
    torch.cuda.synchronize()
    compact_ms = (time.perf_counter() - t0) * 1e3
    buf = pd.hit_buffer(dev)
    pd.prefilter_dense_hits(compacted, *inputs[2:], *buf)
    n = int(buf[2].item())
    w_ms = _host_ms(pd.chunk_hits, (compacted, *inputs[2:], buf),
                    P4_KERNEL_CALLS)
    got = pd.chunk_hits(compacted, *inputs[2:], buf)
    plain = pd.new_hit_buffer(n, dev)
    t0 = time.perf_counter()
    pd.prefilter_dense_hits_plain(compacted, *inputs[2:], *plain)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3
    err = max(_hit_err(got, plain[:2], inputs[3].numel()),
              abs(int(plain[2].item()) - n))
    print(f"phase4 production pass: {compacted[0].shape[0]} compacted "
          f"rows ({compacted[0].shape[0] // pd.ROW_TILE} stages) x "
          f"{inputs[3].numel() // pd.TILE_T} target tiles, {n} hits; "
          f"wrapper with the cursor's read-back and the hits' copy {w_ms} "
          f"ms (one compaction {compact_ms:.3f} ms); plain {p_ms} ms -> "
          f"{cells / (p_ms * 1e-3):.6g} cells/s; kernel vs plain max err "
          f"{err}")
    if err:
        raise AssertionError("phase4 production: kernel != plain")
    del got, plain
    lib_ms, lib_width = _int_mm_ms(compacted[0], inputs)
    print(f"phase4 production pass's library yardstick: torch._int_mm of "
          f"the {compacted[0].shape[0]} compacted int8 rows x the one-hot "
          f"target expansion ({inputs[3].numel()} positions, in blocks of "
          f"{lib_width}) {lib_ms:.3f} ms (the product alone, int32 out)")
    # the bound's work: the int8 product over the rows that can match
    # (the kernel skips the rest) and every position; the hits written
    valid = inputs[1] <= pd.N_OFF * 127
    work = (_nbytes(*inputs[:4]) + n * 8 + 8,
            int(valid.sum()) * inputs[3].numel() * 2 * pd.KDIM)
    bound, bound_by = _bound(*work, INT8_OPS_PER_S)

    # the gate's constants: the whole dense pass at this shape, in cells
    # as the gate counts them (query k-mers x target residues), and the
    # fixed cost of a dense run in a fresh process
    nk = sum(max(len(q_all[k]) - batch.span + 1, 0) for k in keys)
    t0 = time.perf_counter()
    gi, gj = pd.match_pairs(batch, flat, bval, seed_m.scores, kmer_thr,
                            "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    proc = subprocess.run([sys.executable, "-c",
                           "import chip_smoke; chip_smoke.fixed_cost_probe()"],
                          cwd=REPO, capture_output=True, text=True)
    if proc.returncode != 0:
        raise AssertionError(f"phase4 fixed-cost probe exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    fixed = float(proc.stdout.split()[-1])
    rate = nk * len(flat) / wall
    print(f"phase4 gate constants: whole dense pass {wall:.3f} s -> "
          f"{rate:.6g} cells/s ({nk} k-mers x {len(flat)} residues); fixed "
          f"cost of a dense run in a fresh process {fixed:.3f} s")
    # the run's torch.profiler sessions, from here to the end of phase
    # 5(b), one after another
    k_ms, _ = device_ms(pd.prefilter_dense_hits,
                        (compacted, *inputs[2:], *buf),
                        ("counts_kernel", "memset"), P4_KERNEL_CALLS)
    del compacted
    print(f"phase4 production pass alone: {k_ms} ms (counts_kernel and "
          f"the cursor's memset, torch.profiler) -> "
          f"{cells / (k_ms * 1e-3):.6g} cells/s; share of bound "
          f"{bound:.6g} ms ({bound_by}) / {k_ms} ms = {bound / k_ms:.4f}; "
          f"library yardstick {lib_ms:.3f} ms")
    phase3_device_times(p3, clock_hz)
    streams = phase4_streams(batch, gi, gj, flat, starts, seed_m.scores)
    return {"hits": (err, k_ms, p_ms), "library_ms": lib_ms,
            "fixed_s": fixed, "cells_per_s": rate, "work": work,
            "streams": streams}


def _int_mm_ms(qexp_c, inputs, width=16384):
    """(ms, width): torch._int_mm of the counts kernel's compacted int8
    rows [Rc, KDIM] against the one-hot expansion of every target
    position [KDIM, C] (what the kernel builds on the fly), in column
    blocks of `width` positions so that each int32 output fits, timed by
    CUDA events over all blocks after one warm-up block. The library
    yardstick of B2 counts: the port never calls it."""
    import torch
    from spacepharer_tpu_torch.ops import prefilter_dense as pd
    _, _, letters, tval, offsets = inputs
    c = tval.numel()
    texp = torch.zeros((c, pd.KDIM), dtype=torch.int8, device=tval.device)
    rows = torch.arange(c, device=tval.device)
    for p, off in enumerate(offsets):
        texp[rows, p * 21 + letters[off:off + c].long()] = 1
    del rows
    torch._int_mm(qexp_c, texp[:width].t())
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for c0 in range(0, c, width):
        torch._int_mm(qexp_c, texp[c0:c0 + width].t())
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), width


def fixed_cost_probe():
    """Print the seconds from an imported port to the end of a tiny
    dense run on the card: CUDA context, kernel library load (built
    already), first launches."""
    import torch
    from spacepharer_tpu_torch.ops import prefilter_dense as pd
    params, seed_m, batch, flat, bval = _dense_tests().cuda_case(
        "seed0_mask0")
    t0 = time.perf_counter()
    pd.match_pairs(batch, flat, bval, seed_m.scores, params.kmer_threshold(),
                   "cuda")
    torch.cuda.synchronize()
    print(time.perf_counter() - t0)


def phase4_predictmatch(p3, tmp):
    """(c): predictmatch through the CLI with the dense prefilter on the
    card and the host scoring engine; the text must equal phase 3's.
    CUDA is initialised in this process, so the control search is not
    forked: both searches run here, one after the other, through B2 and
    the stream kernels, whose launches are counted (every count set to 0
    just before). Prints where device_prefilter's time goes: the dense
    pass, the query packing, the stream rebuild, the batch finalize and
    the rest (host seconds; phase 4(b) times each kernel alone)."""
    import torch
    from spacepharer_tpu_torch.logging import timings
    from spacepharer_tpu_torch.ops import align
    from spacepharer_tpu_torch.ops import prefilter_dense as pd
    out = os.path.join(tmp, "p4", "dense.tsv")
    os.makedirs(os.path.dirname(out))
    before = timings()
    split = {}
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()), _timed_calls(split, (
            (pd, "device_prefilter_arrays", "device_prefilter"),
            (pd, "match_pairs", "dense pass"),
            (pd, "build_query_batch", "query packing"),
            (pd, "rebuild_streams", "stream rebuild"),
            (pd, "finalize_streams", "batch finalize"),
            (align, "align_query_batch", "alignment"))):
        rc = _cli(["predictmatch", *p3["paths"]["dense"], out,
                   os.path.join(tmp, "p4", "tmp"), "--prefilter-engine",
                   "device", "--use-tpu", "0", "-v", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k[:-len("_launches")]: v for k, v in _since(
        before, "prefilter_dense_hits_launches",
        *(f"{name}_launches" for name, _ in STREAM_KERNELS)).items()}
    dense = _since(before, "prefilter_dense_hits_cells", "dense_hits",
                   "dense_hit_reruns")
    after = timings()
    if rc != 0:
        raise AssertionError(f"phase4 dense predictmatch exited {rc}")
    with open(out) as fh:
        same = fh.read() == p3["host_text"]
    print(f"phase4 predictmatch --prefilter-engine device --use-tpu 0 in "
          f"this process: wall {wall:.3f} s (search "
          f"{after.get('search', 0) - before.get('search', 0):.3f} s, then "
          f"search_rev "
          f"{after.get('search_rev', 0) - before.get('search_rev', 0):.3f} "
          f"s); launches {launches}; dense cells on the card "
          f"{dense['prefilter_dense_hits_cells']}, hits "
          f"{dense['dense_hits']}, chunks run again "
          f"{dense['dense_hit_reruns']}; text identical to the host "
          f"engine's: {same}")
    dp = split.get("device_prefilter", 0.0)
    parts = [(k, split.get(k, 0.0)) for k in ("dense pass", "query packing",
                                              "stream rebuild",
                                              "batch finalize")]
    print(f"phase4 dense route split over both searches: device_prefilter "
          f"{dp:.3f} s (" + ", ".join(f"{k} {v:.3f} s" for k, v in parts)
          + f", the rest {dp - sum(v for _, v in parts):.3f} s); alignment "
          f"(align_query_batch) {split.get('alignment', 0.0):.3f} s")
    if not same:
        raise AssertionError("phase4: dense-prefilter text differs from "
                             "the host engine's")
    if min(launches.values()) <= 0:
        raise AssertionError("phase4: a dense or stream kernel was never "
                             "launched")
    if dense["dense_hit_reruns"]:
        raise AssertionError("phase4: a dense chunk overflowed the hit "
                             "buffer")
    return launches


def fit_dense_terms(rows):
    """((fixed s, s per query k-mer, s per target residue), residuals s):
    the non-negative least-squares fit of x = fixed + a * k-mers + b *
    residues through rows of (k-mers, residues, x), x the seconds phase
    4(d) leaves to the dense route's fixed cost and host work. No term
    is negative: each is time the route spends."""
    from scipy.optimize import nnls
    m = np.array(rows, dtype=np.float64)
    a = np.column_stack([np.ones(len(m)), m[:, :2]])
    coef, _ = nnls(a, m[:, 2])
    return tuple(float(c) for c in coef), [round(float(r), 3)
                                          for r in m[:, 2] - a @ coef]


def phase4_routes(p3, p4, walk):
    """(d): the dense and host routes in fresh processes, as a user runs
    them (each forks its control search onto the host engine), at four
    shapes: phase 3's corpus, its small query side against the same
    target, its query side GATE_BIG_COPIES times over and its query side
    against phase 3(b)'s target-axis point (GATE_TARGET_COPIES mutated
    copies of each golden genome), the last two on fresh copies of phase
    3(b)'s DBs; the texts must agree at each. Fits the gate's dense-route
    terms by non-negative least squares (fit_dense_terms), so that the
    model's dense less host seconds matches the measured difference of
    the walls: a fixed cost
    (_DENSE_FIXED_S: import torch, the CUDA context, the first launches,
    all a fresh process pays once) and the host work per query k-mer and
    per target residue, given (b)'s cell rate and the host walk's terms
    that phase 3(b) measured (`walk`).

    The small query side runs with --fdr 0: at the default 0.05 the FDR
    step of the shared host code (stats/fdr.py) indexes past its score
    list on it (ROADMAP), while --fdr 0 takes its short path. Both
    routes pass the same flag, and the search stages they differ in do
    not read it."""
    from spacepharer_tpu_torch.pipeline import predictmatch as pm
    base, paths = p3["base"], dict(p3["paths"])
    for shape, src in (("big", walk["pristine"][GATE_BIG_COPIES]),
                       ("t", walk["pristine"]["t"])):
        for route in ("host", "dense"):
            dest = os.path.join(base, f"{route}_{shape}")
            shutil.copytree(src, dest)
            paths[f"{route}_{shape}"] = [
                os.path.join(dest, n)
                for n in ("query", "targets", "targets_rev")]
    small = ("--fdr", "0")
    shapes = (("phase-3 corpus", "fresh", ()),
              ("small query side", "small", small),
              (f"query side x{GATE_BIG_COPIES}", "big", ()),
              (f"target axis x{GATE_TARGET_COPIES // COPIES}", "t", ()))
    rows = []
    for label, shape, flags in shapes:
        if shape == "fresh":
            host_wall, host_text = p3["host_wall"], p3["host_text"]
        else:
            host_wall, host_text, _ = _fresh_run(
                base, paths, f"host_{shape}", "--use-tpu", "0", *flags)
        run = f"dense_{shape}"
        wall, text, _ = _fresh_run(base, paths, run, "--prefilter-engine",
                                   "device", "--use-tpu", "0", *flags)
        nk, t_res = _gate_shape(paths[run])
        gate = pm.dense_prefilter_viable(nk, t_res, has_idx=False)
        print(f"phase4 fresh processes, {label} ({nk} k-mers x {t_res} "
              f"residues): dense route {wall:.3f} s, host route "
              f"{host_wall:.3f} s; texts identical {text == host_text}; "
              f"the gate picks {'dense' if gate else 'host'}, the faster "
              f"was {'dense' if wall < host_wall else 'host'}")
        if text != host_text:
            raise AssertionError(f"phase4 {label}: dense and host routes' "
                                 f"texts differ")
        # the measured difference less the model's known terms: what the
        # dense route's fixed cost and host work have to account for
        rows.append((nk, t_res, wall - host_wall
                     + t_res * walk["post_s_per_res"]
                     + nk * walk["walk_s_per_kmer"]
                     - nk * t_res / p4["cells_per_s"]))
    (fixed, per_kmer, per_res), resid = fit_dense_terms(rows)
    print(f"phase4 gate fit (non-negative least squares over the "
          f"{len(rows)} shapes, rows (k-mers, residues, s) "
          f"{[(nk, tr, round(x, 3)) for nk, tr, x in rows]}): the "
          f"dense route's fixed cost in a fresh process {fixed:.6g} s "
          f"(_DENSE_FIXED_S in the code {pm._DENSE_FIXED_S:.6g}; (b)'s probe "
          f"from an imported torch {p4['fixed_s']:.3f} s), host work "
          f"{per_kmer:.6g} s per query k-mer (_DENSE_HOST_S_PER_KMER in the "
          f"code {pm._DENSE_HOST_S_PER_KMER:.6g}), {per_res:.6g} s per "
          f"target residue (_DENSE_HOST_S_PER_RES in the code "
          f"{pm._DENSE_HOST_S_PER_RES:.6g}); residuals s {resid}; with "
          f"phase 3(b)'s host "
          f"walk terms and phase 4(b)'s cell rate {p4['cells_per_s']:.6g} "
          f"(_DENSE_CELLS_PER_S in the code {pm._DENSE_CELLS_PER_S:.6g})")


# ---------------------------------------------------------------- phase 5

def _dev_args(dev, *arrays):
    import torch
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


def phase5_cases(dev):
    """(a): B4 on every `cuda` case of tests/test_torch_sw_pallas.py, and
    B3 on each of its first queries, against their plain versions on the
    card. Returns the max errors (B3, B4)."""
    from spacepharer_tpu_torch.ops import sw_pallas as sp
    tests = _test_module("test_torch_sw_pallas")
    errs = [0, 0]
    for name in tests.CUDA_CASES:
        prof, q_len, t_seqs, t_len, go, ge = tests.cuda_case(name)
        args = _dev_args(dev, prof, q_len, t_seqs, t_len)
        b4 = int((sp.sw_scores_batch(*args, go, ge)
                  - sp.sw_scores_batch_plain(*args, go, ge)).abs().max())
        b3 = 0
        for qi in range(min(6, prof.shape[0])):
            one = (args[0][qi], args[1][qi]) + args[2:]
            b3 = max(b3, int((sp.sw_scores_one_query(*one, go, ge)
                              - sp.sw_scores_one_query_plain(*one, go, ge)
                              ).abs().max()))
        print(f"phase5 {name}: {prof.shape[0]}x{t_seqs.shape[1]} (LQ "
              f"{prof.shape[1]}, LT {t_seqs.shape[0]}, A {prof.shape[2]}): "
              f"max|B4-plain| = {b4}, max|B3-plain| = {b3}")
        if b3 or b4:
            raise AssertionError(f"phase5 {name}: kernel != plain")
        errs = [max(errs[0], b3), max(errs[1], b4)]
    return errs


def phase5_production(dev, golden, p1, clock_hz):
    """(b): B4 at phase 1's shape (golden query ORFs x golden target ORFs
    x P1_DUP, with bias), in the mesh's layout, exact against its plain
    version and timed: the kernel alone (its device time by
    torch.profiler, the targets packed once), the device packing of the
    targets apart, and the whole wrapper with the packing in turns around
    the plain version; and B3 on the longest of those queries against all
    the targets, beside B4 on that one query. The kernels alone come
    first, each session right after the last: B1 on phase 1's pairs
    (p1's ms), B4, B3 and B4 at Q = 1."""
    import torch
    from spacepharer_tpu_torch.io.setdb import SetDB
    from spacepharer_tpu_torch.ops import sw_packed
    from spacepharer_tpu_torch.ops import sw_pallas as sp
    from spacepharer_tpu_torch.ops.align import sw_bias_i8
    from spacepharer_tpu_torch.ops.matrices import load_matrix
    from spacepharer_tpu_torch.parallel import sharding

    m = load_matrix("VTML40.out", 2.0)
    qdb = SetDB.load(_golden_query_path(golden))
    tdb = SetDB.load(os.path.join(golden, "targets"))
    qf, qo = qdb.orf_aa_encoded()
    tf, to = tdb.orf_aa_encoded()
    qs = [qf[qo[i]:qo[i + 1]] for i in range(qdb.n_orfs)]
    ts = [tf[to[i]:to[i + 1]] for i in range(tdb.n_orfs)] * P1_DUP
    t0 = time.perf_counter()
    q_prof, q_len = sharding.pack_queries(
        qs, m.scores, max(8, -(-max(map(len, qs)) // 8) * 8),
        bias_list=[sw_bias_i8(q, m) for q in qs])
    t_seqs, t_len = sharding.pack_targets(
        ts, max(8, -(-max(map(len, ts)) // 8) * 8), x_index=20)
    pack_s = time.perf_counter() - t0
    args = _dev_args(dev, q_prof, q_len, t_seqs.T, t_len)
    A = q_prof.shape[2]
    cells = int(q_len.sum()) * int(t_len.sum())
    dpack_ms = _host_ms(sp.pack_targets, (args[2].t(), args[3], A),
                        P5_KERNEL_CALLS)
    packed = sp.pack_targets(args[2].t(), args[3], A)
    kargs = (args[0], args[1], packed, 16, 2)

    def alone(fn, f_args, kernel="sw_dense_kernel", n=P5_KERNEL_CALLS):
        """(device ms of `kernel` per call, last output)."""
        return device_ms(fn, f_args, (kernel,), n)

    qi = int(np.argmax(q_len))
    one = (args[0][qi], args[1][qi:qi + 1]) + args[2:]
    cells3 = int(q_len[qi]) * int(t_len.sum())
    one4 = (args[0][qi:qi + 1], args[1][qi:qi + 1]) + args[2:]
    # the kernels alone first, one session after another: B1 on phase
    # 1's pairs twice; B4; B3, B4 at Q = 1 twice, B3
    b1 = [alone(sw_packed.sw_allpairs, p1["args"] + (16, 2),
                "sw_allpairs_kernel", P1_KERNEL_CALLS)[0] for _ in range(2)]
    p1["ms"] = min(b1)
    k_ms = [alone(sp.sw_scores_packed, kargs) for _ in range(2)]
    k3, out3 = alone(sp.sw_scores_one_query, one + (16, 2))
    k4one = [alone(sp.sw_scores_batch, one4 + (16, 2)) for _ in range(2)]
    k3 = [k3, alone(sp.sw_scores_one_query, one + (16, 2))[0]]
    print(f"phase1 B1 kernel alone (timed in phase 5(b)) ms {b1} -> "
          f"{p1['cells'] / (p1['ms'] * 1e-3):.6g} cells/s")
    # turns of the wrapper chain around the plain version
    w_ms = [_chain_ms(sp.sw_scores_batch, args, 16, 2, P5_KERNEL_CALLS)]
    p_ms, ref = _chain_out(sp.sw_scores_batch_plain, args, 16, 2, 1,
                           warm=False)
    w_ms.append(_chain_ms(sp.sw_scores_batch, args, 16, 2, P5_KERNEL_CALLS))
    err = max(int((o - ref).abs().max()) for _, o in k_ms)
    w_out = sp.sw_scores_batch(*args, 16, 2)
    err = max(err, int((w_out - ref).abs().max()))
    del ref, w_out
    k_ms = [ms for ms, _ in k_ms]
    b1_ms, b1_chain = p1["ms"], p1["chain_ms"]
    print(f"phase5 production B4: {q_prof.shape[0]}x{t_seqs.shape[0]} "
          f"(LQ {q_prof.shape[1]}, LT {t_seqs.shape[1]}), {cells} true "
          f"cells per call, host packing {pack_s:.3f} s; kernel alone ms "
          f"{k_ms} -> {cells / (min(k_ms) * 1e-3):.6g} cells/s; target "
          f"packing on the card {dpack_ms:.4f} ms; wrapper with the "
          f"packing {w_ms} ms; plain {p_ms} ms -> "
          f"{cells / (p_ms * 1e-3):.6g} cells/s; B1 on the same pairs "
          f"{b1_ms} ms kernel alone -> {p1['cells'] / (b1_ms * 1e-3):.6g} "
          f"cells/s, {b1_chain} ms wrapper chain; B4/B1 "
          f"{min(k_ms) / b1_ms:.4f} (kernels alone), "
          f"{min(w_ms) / b1_chain:.4f} (wrapper chains); "
          f"max|kernel-plain| = {err}")
    k_ms = min(k_ms)
    if err:
        raise AssertionError("phase5 production: B4 != plain")
    p3, ref3 = _chain_out(sp.sw_scores_one_query_plain, one, 16, 2, 1,
                          warm=False)
    err3 = max([int((out3 - ref3).abs().max())]
               + [int((o[0] - ref3).abs().max()) for _, o in k4one])
    k4one = [ms for ms, _ in k4one]
    print(f"phase5 production B3: query {qi} ({int(q_len[qi])} rows) x "
          f"{t_seqs.shape[0]} targets, {cells3} true cells; kernel alone ms "
          f"{k3} -> {cells3 / (min(k3) * 1e-3):.6g} cells/s; B4 on the same "
          f"one query ms {k4one}; plain {p3} ms; max|kernel-plain| = {err3}")
    k3 = min(k3)
    if err3:
        raise AssertionError("phase5 production: B3 (or B4 at Q = 1) != "
                             "plain")
    b4_bound = _sw_bound(_sw_bytes(q_len, A, t_len, 1), cells, clock_hz)
    b3_bound = _sw_bound(_sw_bytes(q_len[qi:qi + 1], A, t_len, 1), cells3,
                         clock_hz)
    torch.cuda.synchronize()
    return {"b4": (err, k_ms, p_ms, b4_bound),
            "b3": (err3, k3, p3, b3_bound)}


def phase5_golden(golden, tmp):
    """(c): the golden DBs through the CLI with --shards 2,4 (B4 per
    shard); the golden bytes."""
    from spacepharer_tpu_torch.logging import timings
    qpath = _golden_query_path(golden)
    with open(os.path.join(golden, "result.tsv")) as gh:
        want = gh.read()
    base = os.path.join(tmp, "p5", "2x4")
    os.makedirs(base)
    before = timings()
    t0 = time.perf_counter()
    rc = _cli(["predictmatch", qpath, os.path.join(golden, "targets"),
               os.path.join(golden, "targets_rev"),
               os.path.join(base, "result.tsv"), os.path.join(base, "tmp"),
               "--shards", "2,4", "--use-tpu", "1", "-v", "1"])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"phase5 --shards 2,4: exited {rc}")
    with open(os.path.join(base, "result.tsv")) as fh:
        same = fh.read() == want
    n = _since(before, "sw_dense_batch_launches")["sw_dense_batch_launches"]
    print(f"phase5 golden via CLI --shards 2,4 --use-tpu 1: "
          f"byte-identical={same}, batch_launches {n}, wall {wall:.3f} s")
    if not same:
        raise AssertionError("phase5 --shards 2,4: result.tsv differs from "
                             "the golden")
    if n <= 0:
        raise AssertionError("phase5 --shards 2,4: B4 was never launched")


def _check_mesh_block(dev, block, seed):
    """Hold CHECK_ROWS random query rows of the largest block the mesh
    scored in (d) against sw_scores_batch_plain on the card. Returns
    max |kernel - plain|."""
    from spacepharer_tpu_torch.ops import sw_pallas as sp
    from spacepharer_tpu_torch.parallel import sharding
    q_list, t_list, kernel_out = block["q"], block["t"], block["out"]
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.choice(len(q_list), min(CHECK_ROWS, len(q_list)),
                              replace=False))
    bias = block["bias"]
    q_prof, q_len = sharding.pack_queries(
        [q_list[i] for i in rows], block["matrix"],
        max(8, -(-max(len(q_list[i]) for i in rows) // 8) * 8),
        bias_list=None if bias is None else [bias[i] for i in rows])
    t_seqs, t_len = sharding.pack_targets(
        t_list, max(8, -(-max(map(len, t_list)) // 8) * 8), x_index=20)
    t0 = time.perf_counter()
    plain = sp.sw_scores_batch_plain(
        *_dev_args(dev, q_prof, q_len, t_seqs.T, t_len), block["go"],
        block["ge"]).cpu().numpy()
    plain_s = time.perf_counter() - t0
    err = int(np.abs(kernel_out[rows].astype(np.int64) - plain).max())
    print(f"phase5 largest block {kernel_out.shape[0]}x"
          f"{kernel_out.shape[1]}: {len(rows)} query rows x all "
          f"{len(t_list)} targets, max|kernel-plain| = {err} (plain on "
          f"the card {plain_s:.3f} s)")
    if err:
        raise AssertionError("phase5: mesh scores != plain on the largest "
                             "block")
    return err


def phase5_corpus(dev, p3, tmp, seed, since):
    """(d): phase 3's corpus through the CLI with --shards 2,4 --use-tpu 1
    --prefilter-engine host in this process: its text must equal the
    host engine's. Times packing, shard scoring and the whole mesh
    scoring inside _search_tpu, and _search_tpu's four steps (bias,
    scoring, E-value screen, survivor alignment). CUDA is initialised,
    so both searches run here one after the other, as in phase 3's GPU
    run. B4's and B3's launches and cells are printed over (c) and (d):
    since the timings() snapshot `since`, taken before (c)."""
    import torch
    from spacepharer_tpu_torch.logging import timings
    from spacepharer_tpu_torch.ops import sw_pallas as sp
    from spacepharer_tpu_torch.parallel import sharding
    from spacepharer_tpu_torch.pipeline import predictmatch as pm

    spent = dict.fromkeys(("pack", "dpack", "score", "mesh", "search_tpu"),
                          0.0)
    largest = {"out": np.zeros((0, 0), dtype=np.int32)}
    patched = ((sharding, "pack_queries"), (sharding, "pack_targets"),
               (sharding, "sharded_allpairs_scores"), (sp, "pack_targets"),
               (sp, "sw_scores_packed"))
    orig = {(mod, name): getattr(mod, name) for mod, name in patched}
    search_tpu = pm._search_tpu

    def timed(key, fn, sync=False):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t
            return out
        return run

    def kept(mesh, q_list, t_list, matrix_scores, bias_list=None,
             gap_open=16, gap_extend=2):
        out = orig[(sharding, "sharded_allpairs_scores")](
            mesh, q_list, t_list, matrix_scores, bias_list, gap_open,
            gap_extend)
        if out.size > largest["out"].size:
            largest.update(q=q_list, t=t_list, matrix=matrix_scores,
                           bias=bias_list, go=gap_open, ge=gap_extend,
                           out=out)
        return out

    sharding.pack_queries = timed("pack", orig[(sharding, "pack_queries")])
    sharding.pack_targets = timed("pack", orig[(sharding, "pack_targets")])
    sharding.sharded_allpairs_scores = timed("mesh", kept)
    sp.pack_targets = timed("dpack", orig[(sp, "pack_targets")], sync=True)
    sp.sw_scores_packed = timed("score", orig[(sp, "sw_scores_packed")],
                                sync=True)
    pm._search_tpu = timed("search_tpu", search_tpu)
    out = os.path.join(p3["base"], "mesh.tsv")
    before = timings()
    t0 = time.perf_counter()
    split = {}
    try:
        with contextlib.redirect_stderr(io.StringIO()), \
                _timed_calls(split, _search_tpu_split(pm)):
            rc = _cli(["predictmatch", *p3["paths"]["mesh"], out,
                       os.path.join(p3["base"], "tmp_mesh"), "--shards",
                       "2,4", "--use-tpu", "1", "--prefilter-engine", "host",
                       "-v", "1"])
    finally:
        for (mod, name), fn in orig.items():
            setattr(mod, name, fn)
        pm._search_tpu = search_tpu
    wall = time.perf_counter() - t0
    after = timings()
    mesh = _since(since, "sw_dense_batch_launches",
                  "sw_dense_one_query_launches", "sw_dense_cells")
    if rc != 0:
        raise AssertionError(f"phase5 mesh predictmatch exited {rc}")
    with open(out) as fh:
        same = fh.read() == p3["host_text"]
    print(f"phase5 corpus via CLI --shards 2,4 --use-tpu 1 "
          f"--prefilter-engine host in this process: wall {wall:.3f} s "
          f"(phase 3's GPU engine {p3['gpu_wall']:.3f} s; search "
          f"{after.get('search', 0) - before.get('search', 0):.3f} s, "
          f"search_rev "
          f"{after.get('search_rev', 0) - before.get('search_rev', 0):.3f}"
          f" s); _search_tpu {spent['search_tpu']:.3f} s: mesh scoring "
          f"{spent['mesh']:.3f} s (host packing {spent['pack']:.3f} s, "
          f"target packing on the card, once per target block, "
          f"{spent['dpack']:.3f} s, B4 launches to a synchronise "
          f"{spent['score']:.3f} s, the rest uploads, downloads and "
          f"padding), the rest {spent['search_tpu'] - spent['mesh']:.3f} "
          f"s; over (c) and "
          f"(d): B4 launches {mesh['sw_dense_batch_launches']}, B3 "
          f"launches {mesh['sw_dense_one_query_launches']}, true cells "
          f"{mesh['sw_dense_cells']}; text "
          f"identical to the host engine's: {same}")
    print("phase5 mesh route " + _split_line(split))
    if not same:
        raise AssertionError("phase5: mesh text differs from the host "
                             "engine's")
    return _check_mesh_block(dev, largest, seed)


def nccl_rank(rank, world, init, inputs, out):
    """One rank of phase 5(e)'s NCCL run: its target shard of `inputs`
    through distributed_search_pipeline on a (1, world) mesh."""
    import torch.distributed as dist
    from spacepharer_tpu_torch.parallel.distributed import (
        distributed_search_pipeline, initialize)
    initialize(init_method=init, world_size=world, rank=rank,
               timeout_s=120)           # NCCL: the script needs CUDA
    d = np.load(inputs)
    tl = len(d["t_seqs"]) // world
    ts = slice(rank * tl, (rank + 1) * tl)
    step = distributed_search_pipeline(1, world, top_k=int(d["top_k"]),
                                       n_sets=int(d["n_sets"]),
                                       n_qsets=int(d["n_qsets"]))
    got = step(d["q_prof"], d["q_len"], d["t_seqs"][ts], d["t_len"][ts],
               d["set_of_t"][ts], d["set_of_q"])
    dist.destroy_process_group()
    np.savez(out, **dict(zip(("sc", "idx", "best", "comb"), got)))


def phase5_entry_points(golden, tmp):
    """(e): graft_entry.dryrun_multichip(8) on the golden DBs (all 8
    shards on the card), and distributed_search_pipeline over NCCL at
    world size torch.cuda.device_count(), one process per card, on the
    same corpus slice; both against the exact host oracle."""
    import torch
    from spacepharer_tpu_torch import graft_entry
    qpath = _golden_query_path(golden)
    tpath = os.path.join(golden, "targets")
    t0 = time.perf_counter()
    shapes = graft_entry.dryrun_multichip(8, qpath, tpath)
    print(f"phase5 dryrun_multichip(8) on the golden DBs: meshes {shapes} "
          f"match the host oracle ({time.perf_counter() - t0:.3f} s)")

    world = torch.cuda.device_count()
    base = os.path.join(tmp, "p5", "nccl")
    os.makedirs(base)
    qs, ts, set_of_t, n_sets = graft_entry.golden_slice(8, qpath, tpath)
    inp = graft_entry.mesh_inputs(qs, ts, set_of_t, 1, world)
    np.savez(os.path.join(base, "inputs.npz"), top_k=4, n_sets=n_sets,
             **{k: inp[k] for k in ("q_prof", "q_len", "t_seqs", "t_len",
                                    "set_of_t", "set_of_q", "n_qsets")})
    init = "file://" + os.path.join(base, "rendezvous")
    env = dict(os.environ, NCCL_SOCKET_IFNAME="lo", GLOO_SOCKET_IFNAME="lo")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke; chip_smoke.nccl_rank({r}, {world}, {init!r}, "
         f"{os.path.join(base, 'inputs.npz')!r}, "
         f"{os.path.join(base, f'out{r}.npz')!r})"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    errs = []
    try:
        for p in procs:
            errs.append((p.communicate(timeout=300)[1], p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (err, rc) in enumerate(errs):
        if rc != 0:
            raise AssertionError(f"phase5 NCCL rank {r} exited {rc}:\n"
                                 f"{err[-4000:]}")
    d = np.load(os.path.join(base, "out0.npz"))
    graft_entry.check_mesh_result(
        inp, n_sets, (d["sc"], d["idx"], d["best"], d["comb"]), 4,
        label=("nccl", world))
    print(f"phase5 distributed_search_pipeline over NCCL, world size "
          f"{world}, mesh (1, {world}): matches the host oracle "
          f"({time.perf_counter() - t0:.3f} s, processes included)")


# ---------------------------------------------------------------- phase 6

def write_sets(db, dest, opener):
    """One FASTA per set of db, named after the set, with its contigs'
    headers and sequences (the tests rebuild the golden inputs so too)."""
    for s, name in enumerate(db.set_names):
        with opener(os.path.join(dest, name), "wb") as fh:
            for c in range(db.n_contigs):
                if db.contig_to_set[c] == s:
                    fh.write(b">" + db.contig_header[c].encode() + b"\n"
                             + db.contig_seq(c).tobytes() + b"\n")


def write_keyed_targets(fix):
    """<fix>/t_keyed.fasta: a blastn fixture's t.fasta in the reference
    createdb's key order (tdb.lookup), which duplicate-target tie-breaks
    follow; returns its path."""
    from spacepharer_tpu_torch.io.fasta import iter_fasta
    entries = {e.name: e for e in iter_fasta(os.path.join(fix, "t.fasta"))}
    path = os.path.join(fix, "t_keyed.fasta")
    with open(os.path.join(fix, "tdb.lookup")) as fh, \
            open(path, "wb") as out:
        for ln in fh:
            e = entries[ln.split("\t")[1]]
            out.write(b">" + e.header.encode() + b"\n" + e.seq.tobytes()
                      + b"\n")
    return path


def _launcher(args, cwd, what):
    """bin/spacepharer_torch in a fresh process, on this interpreter:
    (wall s, stdout, stderr); fails on a non-zero exit."""
    env = dict(os.environ, PATH=os.path.dirname(sys.executable)
               + os.pathsep + os.environ.get("PATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([LAUNCHER] + args, cwd=cwd, env=env,
                          capture_output=True, text=True)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"phase6 {what} exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    return wall, proc.stdout, proc.stderr


def _same_bytes(path, ref, what):
    with open(path, "rb") as fh, open(ref, "rb") as gh:
        if fh.read() != gh.read():
            raise AssertionError(f"phase6 {what}: {path} differs from {ref}")


def phase6(dev, golden, tmp, smi):
    """The product surface through the launcher, (a) to (e) of the
    module's docstring; smi is the card's name and power limit. Returns
    the max error of B2's pass at the golden shape."""
    import torch
    from spacepharer_tpu_torch.io.setdb import SetDB
    from spacepharer_tpu_torch.logging import timings
    from spacepharer_tpu_torch.ops import prefilter_dense as pd
    t_phase = time.perf_counter()
    base = os.path.join(tmp, "p6")
    fa = os.path.join(base, "inputs")
    os.makedirs(fa)
    write_sets(SetDB.load(os.path.join(golden, "targets")), fa, gzip.open)
    qdb = SetDB.load(_golden_query_path(golden))
    write_sets(qdb, fa, open)
    genomes = sorted(os.path.join(fa, f) for f in os.listdir(fa)
                     if f.startswith("GCA_"))
    spacers = [os.path.join(fa, name) for name in qdb.set_names]
    gold = os.path.join(golden, "result.tsv")
    walls = {}
    for name, extra in (("targets", []),
                        ("targets_rev", ["--reverse-fragments", "1"])):
        walls[f"createsetdb {name}"] = _launcher(
            ["createsetdb", *genomes, name, "tmp", *extra], base,
            f"createsetdb {name}")[0]

    walls["easy-predict auto"], out, err = _launcher(
        ["easy-predict", *spacers, "targets", "auto.tsv", "tmp_auto"], base,
        "easy-predict (auto gates)")
    _same_bytes(os.path.join(base, "auto.tsv"), gold, "easy-predict auto")
    engines = [ln.strip() for ln in (out + err).splitlines()
               if "scoring engine" in ln]
    dense = any("dense device prefilter" in ln
                for ln in (out + err).splitlines())
    print(f"phase6 easy-predict with the auto gates (fresh process): golden "
          f"bytes; prefilter {'dense (B2)' if dense else 'host walk'}; "
          f"scoring: {engines}")

    # the dense route's match_pairs inputs, as the product path gives
    # them, for (c)'s check of B2 at this shape
    recorded, match_pairs = [], pd.match_pairs

    def recording(*a, **kw):
        recorded.append(a)
        return match_pairs(*a, **kw)

    launches = {}
    pd.match_pairs = recording
    try:
        for label, flags in (("use-tpu 1", ["--use-tpu", "1"]),
                             ("dense", ["--prefilter-engine", "device",
                                        "--use-tpu", "0"])):
            before = timings()
            out_tsv = os.path.join(base, f"{label.replace(' ', '_')}.tsv")
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(io.StringIO()):
                rc = _cli(["easy-predict", *spacers,
                           os.path.join(base, "targets"), out_tsv,
                           os.path.join(base,
                                        f"tmp_{label.replace(' ', '_')}"),
                           "-v", "1", *flags])
            walls[f"easy-predict {label}"] = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"phase6 easy-predict {label} exited "
                                     f"{rc}")
            _same_bytes(out_tsv, gold, f"easy-predict {label}")
            launches[label] = {
                k[:-len("_launches")]: v for k, v in _since(
                    before, "sw_pairs_launches",
                    "prefilter_dense_hits_launches",
                    *(f"{n}_launches" for n, _ in STREAM_KERNELS)).items()}
    finally:
        pd.match_pairs = match_pairs
    print(f"phase6 launches (easy-predict in this process; not in the "
          f"kernel report): {launches}")
    if launches["use-tpu 1"]["sw_pairs"] <= 0:
        raise AssertionError("phase6: easy-predict --use-tpu 1 never "
                             "launched the pair kernel")
    if min(launches["dense"][name] for name in (
            "prefilter_dense_hits", *(n for n, _ in STREAM_KERNELS))) <= 0:
        raise AssertionError("phase6: easy-predict --prefilter-engine "
                             "device never launched the B2 kernel and "
                             "the stream kernels")

    # (c) B2's pass on each dense search's own inputs (the golden query
    # k-mer rows x the golden masked target, its ragged last tile
    # included), kernel vs plain
    if len(recorded) != launches["dense"]["prefilter_dense_hits"]:
        raise AssertionError(f"phase6: {len(recorded)} dense searches, "
                             f"{launches['dense']} launches")
    worst = 0
    for i, args in enumerate(recorded):
        err, _ = _dense_check(f"golden dense search {i}",
                              pd.dense_inputs(*args, dev), "phase6")
        worst = max(worst, err)
    torch.cuda.synchronize()

    blastn = os.path.join(base, "blastn")
    with tarfile.open(os.path.join(REPO, "tests",
                                   "blastn_fixtures.tar.gz")) as tf:
        tf.extractall(blastn, filter="fully_trusted")   # the repo's own
    for name in BLASTN_FIXTURES:
        fix = os.path.join(blastn, name)
        write_keyed_targets(fix)
        walls[f"searchnucl {name}"] = _launcher(
            ["searchnucl", "q.fasta", "t_keyed.fasta", "out.m8"], fix,
            f"searchnucl {name}")[0]
        _same_bytes(os.path.join(fix, "out.m8"),
                    os.path.join(fix, "ref.m8"), f"searchnucl {name}")
    print(f"phase6 searchnucl {list(BLASTN_FIXTURES)}: ref.m8 byte for byte")
    print("phase6 walls s: " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in walls.items())
          + f"; phase 6 in all {time.perf_counter() - t_phase:.3f} ({smi})")
    return worst


def _kernel_name(mangled):
    """The unqualified name of a mangled kernel function (the last name
    of its nested name), or the name as it is where it is not mangled."""
    m = re.match(r"_Z(N?)", mangled)
    if not m:
        return mangled
    names, i = [], m.end()
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        names.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
        if not m.group(1):
            break
    return names[-1] if names else mangled


def _sass_opcodes(path):
    """{kernel function: Counter of its SASS opcodes} of a built library
    (cuobjdump -sass prints a `Function :` header per kernel), or None
    where cuobjdump is missing or fails."""
    from torch.utils.cpp_extension import CUDA_HOME
    tool = shutil.which("cuobjdump") or os.path.join(
        CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    try:
        proc = subprocess.run([tool, "-sass", path], capture_output=True,
                              text=True)
    except OSError as exc:
        print(f"phase0 cuobjdump: {exc}")
        return None
    if proc.returncode != 0:
        print(f"phase0 cuobjdump exited {proc.returncode}: "
              f"{proc.stderr[-500:]}")
        return None
    funcs = collections.defaultdict(collections.Counter)
    ops = None
    for line in proc.stdout.splitlines():
        f = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if f:
            ops = funcs[_kernel_name(f.group(1))]
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if m and ops is not None:
            ops[m.group(1)] += 1
    return dict(funcs)


def _build_all():
    """Build every kernel library at once (one nvcc each), print each
    one's ptxas registers and spills, and the counts of SASS_COUNTED's
    opcodes per kernel function; fail unless the counts kernel runs on
    warpgroup products alone (IGMMA, no IMMA), or if the profile kernel
    has a DFMA (where cuobjdump can read it). Returns {library: {function: {opcode:
    count}}}."""
    from spacepharer_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as ex:
        for fut in [ex.submit(_cuda.library, name) for name in KERNELS]:
            fut.result()
    print(f"phase0 kernels ready in {time.perf_counter() - t0:.3f} s")
    for name in KERNELS:
        print(f"phase0 {name}: nvcc "
              f"{_cuda.build_seconds.get(name, 0):.3f} s")
        for line in _cuda.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("phase0 ptxas:", line.strip())
    sass = {}
    for name, pattern in SASS_COUNTED.items():
        funcs = _sass_opcodes(_cuda.lib_paths[name])
        if funcs is None:
            continue
        sass[name] = {}
        for func, ops in sorted(funcs.items()):
            sass[name][func] = {op: n for op, n in sorted(ops.items())
                                if pattern.search(op)}
            print(f"phase0 SASS {name} {func}: {sum(ops.values())} "
                  f"instructions; {sass[name][func]}")
    # counts runs on warpgroup products (wgmma) alone
    counts = sass.get("prefilter_dense", {}).get("counts_kernel", {})
    if (not any(op.startswith("IGMMA") for op in counts)
            or any(op.startswith("IMMA") for op in counts)):
        raise AssertionError("phase0: counts_kernel's SASS has no IGMMA, or "
                             "has IMMA (or could not be read)")
    # the bias is float64 rounded step by step: a DFMA would fuse two
    if any(op.startswith("DFMA") for ops in sass.get("pair_profile", {})
           .values() for op in ops):
        raise AssertionError("phase0: DFMA in pair_profile.cu's SASS")
    return sass


def _host_ms(fn, args, n):
    """Mean host ms of n calls of fn(*args), each ended by a synchronise
    (for work that waits on the card inside, as the target packing)."""
    import torch
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()

    # the kernels are built from the sources beside this script, never
    # from a copy of the package found elsewhere on the path
    if not os.path.isdir(os.path.join(REPO, "spacepharer_tpu_torch")):
        print(f"chip_smoke: no spacepharer_tpu_torch/ beside {__file__}; "
              "run it from a checkout of the repo", file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]) * 1e6
    print(f"phase0 torch {torch.__version__} CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), clocks.max.sm "
          f"{clock_hz / 1e6:.0f} MHz")
    _build_all()

    from spacepharer_tpu_torch.logging import timings
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        golden = _golden_dir(tmp)
        p1 = phase1(dev, golden)
        phase2(golden, tmp)
        p3 = phase3(golden, tmp, args.seed, clock_hz)
        walk = phase3_gates(p3, golden, args.seed)
        case_err = phase4_cases(dev)
        stream_case_err = phase4_stream_cases()
        p4 = phase4_production(dev, p3, clock_hz)
        # 5(b) times its kernels right after 4(b)'s sessions
        p5 = phase5_production(dev, golden, p1, clock_hz)
        p4_launches = phase4_predictmatch(p3, tmp)
        phase4_routes(p3, p4, walk)
        p5_errs = phase5_cases(dev)
        # the slice's main path: the mesh route through the CLI
        p5_before = timings()
        phase5_golden(golden, tmp)
        p5_block_err = phase5_corpus(dev, p3, tmp, args.seed, p5_before)
        p5_launches = {k[:-len("_launches")]: v for k, v in _since(
            p5_before, "sw_dense_one_query_launches",
            "sw_dense_batch_launches").items()}
        phase5_entry_points(golden, tmp)
        p6_err = phase6(dev, golden, tmp, smi)
    print(f"chip_smoke: phases 0-6 in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    sw_src, sw_replaces = KERNELS["sw_allpairs"]
    pp_src, pp_replaces = KERNELS["pair_profile"]
    pd_src, pd_replaces = KERNELS["prefilter_dense"]
    sd_src, sd_replaces = KERNELS["sw_dense"]
    bound, bound_by = _sw_bound(p1["bytes"], p1["cells"], clock_hz)
    report = [{"name": "sw_allpairs", "route": "cuda", "source": sw_src,
               "replaces": sw_replaces,
               "launches": p3["launches"]["sw_allpairs"],
               "max_abs_err": p1["max_abs_err"],
               "ms": p1["ms"], "plain_ms": p1["plain_ms"],
               "bound_ms": bound, "bound_by": bound_by, "library_ms": None},
              {"name": "sw_pairs", "route": "cuda", "source": sw_src,
               "replaces": sw_replaces,
               "launches": p3["launches"]["sw_pairs"],
               "max_abs_err": max(p1["pair_err"], p3["max_abs_err"]),
               "ms": p3["ms"], "plain_ms": p3["plain_ms"],
               "bound_ms": p3["bound"][0], "bound_by": p3["bound"][1],
               "library_ms": None},
              # the pair entry's key pass: part of B1's pair-list port
              {"name": "sw_pairs_keys", "route": "cuda", "source": sw_src,
               "replaces": sw_replaces,
               "launches": p3["launches"]["sw_pairs_keys"],
               "max_abs_err": p3["keys"]["max_abs_err"],
               "ms": p3["keys"]["ms"], "plain_ms": p3["keys"]["plain_ms"],
               "bound_ms": p3["keys"]["bound"][0],
               "bound_by": p3["keys"]["bound"][1], "library_ms": None},
              {"name": "pair_profile", "route": "cuda", "source": pp_src,
               "replaces": pp_replaces,
               "launches": p3["launches"]["pair_profile"],
               "max_abs_err": p3["profile"]["max_abs_err"],
               "ms": p3["profile"]["ms"],
               "plain_ms": p3["profile"]["plain_ms"],
               "bound_ms": p3["profile"]["bound"][0],
               "bound_by": p3["profile"]["bound"][1], "library_ms": None}]
    err, ms, plain_ms = p4["hits"]
    bound, bound_by = _bound(*p4["work"], INT8_OPS_PER_S)
    report.append({"name": "prefilter_dense_hits", "route": "cuda",
                   "source": pd_src,
                   "replaces": f"{pd_replaces}, {EMIT_REPLACES}",
                   "launches": p4_launches["prefilter_dense_hits"],
                   "max_abs_err": max(case_err, err, p6_err), "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": bound_by, "library_ms": p4["library_ms"]})
    ps_src, ps_replaces = KERNELS["prefilter_streams"]
    for name, part in STREAM_KERNELS:
        err, ms, plain_ms, (bound, bound_by), lib_ms = p4["streams"][part]
        report.append({"name": name, "route": "cuda", "source": ps_src,
                       "replaces": ps_replaces,
                       "launches": p4_launches[name],
                       "max_abs_err": max(stream_case_err, err), "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": bound_by, "library_ms": lib_ms})
    for name, replaces, key, case_err, extra_err in (
            ("sw_dense_one_query", ONE_QUERY_REPLACES, "b3", p5_errs[0], 0),
            ("sw_dense_batch", sd_replaces, "b4", p5_errs[1],
             p5_block_err)):
        err, ms, plain_ms, (bound, bound_by) = p5[key]
        report.append({"name": name, "route": "cuda", "source": sd_src,
                       "replaces": replaces, "launches": p5_launches[name],
                       "max_abs_err": max(case_err, err, extra_err),
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": bound_by, "library_ms": None})
    missing = [k["name"] for k in report if k["launches"] <= 0
               and k["name"] not in NO_PRODUCT_CALLER]
    if missing:
        raise AssertionError(f"kernels never launched on their main path: "
                             f"{missing}")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
