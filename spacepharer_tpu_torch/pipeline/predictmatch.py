"""The predictmatch pipeline: search -> aggregate -> calibrate -> report.

In-memory re-design of data/predictmatch.sh:27-294 — one orchestrator
instead of a tree of processes; arrays instead of text DB files. Each
stage mirrors its reference module (citations in the stage modules).
"""
import contextlib
import os

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..io.setdb import SetDB
from ..ops.align import INT_MAX, AlnParams, align_query
from ..ops.evalue import EvalueComputer, gumbel_params
from ..ops.matrices import load_matrix
from ..ops.prefilter import PrefilterParams, build_target_index, prefilter_query
from ..report.convert import convert_alignments, merge_entries_by_set
from ..report.nuclaln import combine_prot_nucl, protein_aln_to_nucl
from ..report.offsets import offset_alignments, truncate_best_hits
from ..report.pam import find_pam
from ..report.summarize import summarize_results
from ..logging import count, log, span
from ..stats.aggregation import best_hit_per_set, combine_score, merge_results_by_set
from ..stats.fdr import filter_match_by_fdr


@dataclass
class PredictParams:
    prefilter: PrefilterParams = field(default_factory=PrefilterParams)
    align: AlnParams = field(default_factory=AlnParams)
    fdr: float = 0.05
    tax_fdr: float = 0.02
    fmt: int = 1
    report_fdr: bool = False
    report_pam: bool = True
    perform_nucl_aln: bool = True
    nucl_gap_open: int = 10
    nucl_gap_extend: int = 2
    restrict_ranks_mode: bool = True
    rank_min_seq_ids: tuple = (0.86, 0.84, 0.82, 0.80, 0.78, 0.76, 0.74, 0.72)
    threads: int = 0  # 0 = all cores; 1 = sequential
    # None = auto: the accelerator (a CUDA GPU) is the default scoring
    # engine when one is attached and the workload amortizes transfer +
    # kernel build; True forces the device engine
    use_tpu: Optional[bool] = None
    # (q_shards, t_shards) device mesh for the scoring step; None =
    # single device. Shards sit on the CUDA devices, several on one card
    # when there are fewer cards than shards (parallel/sharding.py).
    mesh: Optional[tuple] = None
    # where the device routes (--use-tpu 1, --shards, --prefilter-engine
    # device) run: "cuda", where they raise without a card, or "cpu", the
    # caller's explicit ask for the kernels' plain versions and the torch
    # scan on the CPU (the CLI reads it from DEVICE_ENV). Output bytes do
    # not depend on it, so it stays out of the workflow cache's key.
    device: str = field(default="cuda", repr=False)
    # torch.profiler trace output dir (SURVEY 5.1: the device-side
    # observability analog of the reference's prefilter statistics);
    # None = off. The chrome trace opens in chrome://tracing / Perfetto.
    trace_dir: Optional[str] = None


_worker_fn = None

# The environment variable through which a CLI user asks for the device
# routes on the CPU (PredictParams.device): "cpu" or "cuda" (the default).
DEVICE_ENV = "SPACEPHARER_TORCH_DEVICE"


def requested_device() -> str:
    """PredictParams.device as DEVICE_ENV asks for it."""
    device = os.environ.get(DEVICE_ENV, "cuda")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"{DEVICE_ENV} must be 'cuda' or 'cpu', got "
                         f"{device!r}")
    return device


def _require_card(params, route: str):
    """Raise unless a CUDA card is attached or the caller asked for the
    CPU (params.device): a device route never runs on the CPU unasked."""
    if params.device == "cpu" or _accelerator_present():
        return
    raise RuntimeError(
        f"{route} needs a CUDA device and none is attached; set "
        f"{DEVICE_ENV}=cpu (PredictParams(device='cpu')) to run it on the "
        "CPU")


# Dense-prefilter cost model, measured by chip_smoke.py on an NVIDIA H100
# 80GB HBM3 at a 700 W power limit, all terms (these and the host walk's
# below) from one call: the dense cells (query k-mers x target residues,
# as the gate counts them) per second of the whole dense pass (the query
# side's int8 Qexp, prep, both kernels, transfers) at the production
# shape of phase 4(b) (94,223 k-mers x 6,919,175 residues in 0.290 s) ...
_DENSE_CELLS_PER_S = 2.25099e12
# ... and, fitted in phase 4(d) by least squares (every term came out
# non-negative) so that the model's dense less host seconds matches the
# measured difference of the two routes' fresh-process walls at four
# shapes, given the cell rate above and the host walk's terms below, the
# dense route's fixed cost in a fresh process (import torch, the CUDA
# context, the kernel libraries' load, first launches; the one-time nvcc
# build left out) and its host work (target masking, query packing and
# composition bias, the stream read-back, the batch finalize, the batched
# alignment) per query k-mer and per target residue. The four shapes,
# dense / host walls: the phase-3 corpus (94,223 k-mers x 6,919,175
# residues: 9.756 / 6.006 s), its small query side (2,149 k-mers: 9.180 /
# 3.357 s), its query side x10 (942,230 k-mers: 30.699 / 23.912 s) and
# its query side against 3x the target genomes (20,746,310 residues:
# 14.843 / 9.987 s); residuals -1.189, 1.072, 0.116, 0.0 s. The host
# route won at all four, and the model picks it there. The per-residue
# term is the least resolved (0 to 1.8e-7 s in the three calls that
# fitted it), so the dense picks the model makes at targets far above
# 2e7 residues (a few thousand k-mers against 3e8-5e8 residues) are
# extrapolations.
_DENSE_FIXED_S = 5.07807
_DENSE_HOST_S_PER_KMER = 2.26421e-5
_DENSE_HOST_S_PER_RES = 9.71868e-9

# Host batch-walk cost model (native prefilter_batch), measured by
# chip_smoke.py phase 3(b) in the same call, medians of three fresh
# processes: the postings build of the phase-3 target (0.399, 0.398,
# 0.438 s for 6,919,175 residues; no persisted index) and the walk of its
# 94,223 query k-mers (2.231, 2.174, 2.232 s).
_HOST_POSTINGS_S_PER_RES = 5.76178e-8
_HOST_WALK_S_PER_KMER = 2.36748e-5


def dense_prefilter_viable(nk_total: int, t_res: int, has_idx: bool) -> bool:
    """Auto gate of the dense GPU prefilter (no accelerator probe); the
    `auto` route of search_setdbs asks it before probing for a card.

    The dense engine is O(query k-mers x target residues) on the card,
    plus host work per query k-mer and per target residue, while the
    host postings walk is output-sensitive, so the dense run, fixed cost
    included, must beat the estimated host walk (plus its postings build
    when no index is persisted). The device-seconds cap keeps a huge
    dense product off the card however slow the host estimate is."""
    dense_cells = nk_total * t_res
    dense_seconds = (dense_cells / _DENSE_CELLS_PER_S + _DENSE_FIXED_S
                     + nk_total * _DENSE_HOST_S_PER_KMER
                     + t_res * _DENSE_HOST_S_PER_RES)
    host_seconds = (0.0 if has_idx else t_res * _HOST_POSTINGS_S_PER_RES) \
        + nk_total * _HOST_WALK_S_PER_KMER
    return (dense_cells > (1e12 if has_idx else 1e10)
            and dense_seconds < 15.0 + _DENSE_FIXED_S
            and dense_seconds < host_seconds)


def device_scoring_engages(use_tpu, mesh, cells,
                           accel_present=None) -> bool:
    """Scoring-engine choice for a known candidate-cell count. The
    accelerator probe (torch.cuda.is_available) can initialise the CUDA
    driver, so it runs only AFTER the cell threshold passes —
    catalog-scale searches (sparse candidates) never pay it."""
    if use_tpu is False:
        return False
    if use_tpu or mesh is not None:
        return True
    if cells <= _DEVICE_CELLS_THRESHOLD:
        return False
    if accel_present is None:
        accel_present = _accelerator_present
    return bool(accel_present())


def _run_chunk(chunk):
    return [_worker_fn(qkey) for qkey in chunk]


def search_setdbs(query_db: SetDB, target_db: SetDB,
                  params: PredictParams, keys=None) -> dict:
    """Translated search: prefilter + SW on AA ORFs; optional nucleotide
    re-alignment merge. Returns {query_orf_key: 11-col text rows}.

    sens_steps > 1 runs the iterative sensitivity loop of the generic
    search workflow (blastp.sh:24-99): each step searches the remaining
    queries at the next sensitivity (start_sens -> sensitivity), rows
    concatenate per query (mergedbs semantics), and queries reaching
    >= 2 alignments stop early. SpacePHARER's own operating point is
    STEPS=1, which keeps the byte-parity path untouched.

    Runs in the span search_setdbs, its stages in child spans
    (target_orfs, query_prep, engine_choice, masked_target or
    target_index, dense_pass or host_prefilter, host_align or
    card_scoring, save_join, nucl_merge)."""
    with span("search_setdbs"):
        return _search_setdbs(query_db, target_db, params, keys)


def _search_setdbs(query_db, target_db, params, keys):
    from dataclasses import replace
    from ..ops.prefilter import SimilarKmerEnumerator

    if params.prefilter.sens_steps > 1 and keys is None:
        senses = np.linspace(params.prefilter.start_sens,
                             params.prefilter.sensitivity,
                             params.prefilter.sens_steps)
        active = list(range(query_db.n_orfs))
        merged = {k: [] for k in active}
        for si, sens in enumerate(senses):
            p1 = replace(params,
                         prefilter=replace(params.prefilter,
                                           sensitivity=float(sens),
                                           sens_steps=1),
                         perform_nucl_aln=False)
            log(2, f"sensitivity step {si + 1}/{len(senses)}: "
                   f"-s {sens:.2f}, {len(active)} queries")
            rows = search_setdbs(query_db, target_db, p1, keys=active)
            for k in active:
                merged[k].extend(rows[k])
            active = [k for k in active if len(rows[k]) < 2]
            if not active:
                break
        return _nucl_merged(merged, query_db, target_db, params)

    with span("target_orfs"):
        with span("target_encode"):
            t_flat, t_off = target_db.orf_aa_encoded()
        with span("target_slices"):
            t_aa = [t_flat[t_off[i]:t_off[i + 1]]
                    for i in range(target_db.n_orfs)]
    t_res = int(t_off[-1])
    limit_b = params.prefilter.split_memory_limit << 20
    split_mode = bool(limit_b) and t_res * 16 > limit_b

    from ..ops.bias import local_aa_bias_batch
    from ..native import get_lib as _get_lib

    with span("query_prep"):
        m40 = load_matrix(params.align.matrix, 2.0)
        seed_m = load_matrix(params.prefilter.seed_matrix, 8.0)
        ungapped_m = load_matrix(params.prefilter.ungapped_matrix, 2.0)
        enumerator = SimilarKmerEnumerator(seed_m.scores)
        evaluer = EvalueComputer(
            gumbel_params(params.align.matrix, params.align.gap_open,
                          params.align.gap_extend),
            t_res)
        q_flat, q_off = query_db.orf_aa_encoded()
        q_all = [q_flat[q_off[k]:q_off[k + 1]]
                 for k in range(query_db.n_orfs)]
        if keys is None:
            keys = list(range(query_db.n_orfs))
        use_batch = (_get_lib() is not None
                     and params.prefilter.kmer_size == 6)
        kmer_span = params.prefilter.pattern_span
        nk_total = sum(max(len(q_all[k]) - kmer_span + 1, 0) for k in keys)
        q_res_total = int(sum(len(q_all[k]) for k in keys))
    count("query_kmers", nk_total)

    # Query bias is only materialized in Python for the engines that
    # need it host-side (dense device prefilter, per-query fallbacks);
    # the native batch drivers recompute it bit-identically in C from
    # the shared expected-score table (ops/bias.py).
    _bias_cache = []

    def _get_bias80():
        if not _bias_cache:
            if params.prefilter.comp_bias_corr:
                _bias_cache.append(local_aa_bias_batch(q_all, seed_m))
            else:
                _bias_cache.append([np.zeros(len(q)) for q in q_all])
        return _bias_cache[0]

    with span("engine_choice"):
        # prefilter engine choice (SURVEY 7.2 step 3). The dense device
        # engine (ops/prefilter_dense.py) needs no postings index — only the
        # tantan-masked flat target — so a fresh-index search skips the
        # postings build (the dominant host cost at scale). Output is
        # byte-identical either way; this is purely a performance routing.
        pf_engine = params.prefilter.engine
        use_dev_pf = False
        if not split_mode:
            if pf_engine == "device":
                use_dev_pf = True
            elif pf_engine == "auto" and params.use_tpu is False:
                # --use-tpu 0 disables EVERY device engine, including the
                # dense prefilter (and keeps forked control searches off
                # the card)
                use_dev_pf = False
            elif pf_engine == "auto":
                from ..ops.prefilter import persisted_index_exists
                has_idx = bool(target_db.path) and persisted_index_exists(
                    target_db.path, params.prefilter)
                # shape gates first; the CUDA-initialising accelerator
                # probe only runs when they pass (dense_prefilter_viable)
                use_dev_pf = (dense_prefilter_viable(nk_total, t_res, has_idx)
                              and _accelerator_present())

        # Scoring engine choice. The accelerator pays a fixed in-process
        # cost (runtime init + compiled-kernel load, seconds) plus
        # per-dispatch packing; the host C aligner runs ~4e9 DP cells/s/
        # core. The real alignment workload is set by the PREFILTER OUTPUT,
        # not by |queries| x |DB| (the reference's own design premise: the
        # prefilter exists to make alignment output-sensitive,
        # Prefiltering.cpp:709-897). So: a cheap a-priori ceiling
        # (every query hitting max_seqs average-length candidates) gates a
        # two-phase path — prefilter first, then decide with exact
        # candidate cells — while small workloads keep the fused
        # prefilter+align path with no second fork.
        avg_t = t_res / max(len(t_aa), 1)
        cells_ceiling = (q_res_total
                         * min(params.prefilter.max_seqs, len(t_aa)) * avg_t)
        use_tpu = params.use_tpu

        batched_aln_ok = (params.align.max_accept == INT_MAX
                          and params.align.max_rejected == INT_MAX
                          and params.align.cov_thr == 0
                          and params.align.seq_id_thr == 0
                          and params.align.aln_len_thr == 0)
        # A search that could go to a device engine imports torch, probes
        # for a card and creates its CUDA context on a thread while the host
        # builds its index and walks (the native walk releases the GIL):
        # only on the batch route with batched alignment, where no fork
        # follows the walk in this search (_run_keyed and
        # _fork_reverse_search also wait for the thread before they fork).
        if (use_batch and batched_aln_ok and not use_dev_pf and not split_mode
                and use_tpu is not False
                and (use_tpu or params.mesh is not None
                     or cells_ceiling > _DEVICE_CELLS_THRESHOLD)):
            _start_torch_probe()

    index = None
    save_thread = None
    masked = None
    if use_dev_pf:
        with span("masked_target"):
            masked, save_thread = _masked_target(t_aa, (t_flat, t_off),
                                                 target_db, params)
    elif not split_mode:
        with span("target_index"):
            index, save_thread = _target_index(t_aa, (t_flat, t_off),
                                               target_db, params)

    def _one_query(qkey):
        q = q_all[qkey]
        hits = prefilter_query(q, index, params.prefilter,
                               enumerator=enumerator,
                               bias80=_get_bias80()[qkey])
        results = align_query(q, [h.target for h in hits], t_aa, m40,
                              params.align, evaluer)
        return [r.row_fields() for r in results]

    def _prefilter_one(qkey):
        hits = prefilter_query(q_all[qkey], index, params.prefilter,
                               enumerator=enumerator,
                               bias80=_get_bias80()[qkey])
        return [h.target for h in hits]

    def _chunk_packed(chunk):
        """(flat, offsets) view when the chunk is a contiguous key
        range (the common case: keys = range(n_orfs)) — skips the
        per-chunk concatenation in the batch wrappers."""
        k0, k1 = chunk[0], chunk[-1]
        if k1 - k0 + 1 != len(chunk) or list(chunk) != list(
                range(k0, k1 + 1)):
            return None
        return (q_flat, q_off[k0:k1 + 2])

    def _prefilter_batch_keys():
        """Native batch prefilter over all keys (chunked for progress
        feedback); candidate pairs stay raw arrays per chunk:
        [(chunk_keys, cand_t, cand_off), ...]."""
        from ..ops.prefilter import prefilter_query_batch
        from ..logging import Progress
        prog = Progress(total=len(keys), label="prefilter ")
        out = []
        for lo in range(0, len(keys), _BATCH_CHUNK):
            chunk = keys[lo:lo + _BATCH_CHUNK]
            ct, _, _, co = prefilter_query_batch(
                [q_all[k] for k in chunk], index, params.prefilter,
                seed_m, ungapped_m, packed=_chunk_packed(chunk),
                as_arrays=True)
            out.append((chunk, ct, co))
            prog.update(len(chunk))
        prog.done()
        return out

    def _align_batch_chunks(cand_chunks):
        from ..ops.align import align_query_batch
        from ..logging import Progress
        prog = Progress(total=len(keys), label="align ")
        prot = {}
        for chunk, ct, co in cand_chunks:
            res = align_query_batch(
                [q_all[k] for k in chunk], None,
                t_flat, t_off, m40, params.align, evaluer,
                packed=_chunk_packed(chunk), cand_arrays=(ct, co),
                as_rows=True)
            for k, rows in zip(chunk, res):
                prot[k] = rows
            prog.update(len(chunk))
        prog.done()
        return prot

    n_threads = params.threads if params.threads > 0 else (os.cpu_count() or 1)
    prot = {}
    if split_mode:
        log(2, "RAM-bounded target splits "
               f"(limit {params.prefilter.split_memory_limit} MB)")
        prot = _search_split(t_aa, (t_flat, t_off), params, m40,
                             enumerator, evaluer, _get_bias80(), q_all, keys)
        return _nucl_merged(prot, query_db, target_db, params)

    def _device_engage(cells):
        return device_scoring_engages(use_tpu, params.mesh, cells)

    if use_batch:
        two_phase = True       # batch route is always prefilter-first
    else:
        two_phase = use_dev_pf or (use_tpu is not False and (
            use_tpu or params.mesh is not None
            or (cells_ceiling > _DEVICE_CELLS_THRESHOLD
                and _accelerator_present())))

    if two_phase or use_batch:
        if use_dev_pf:
            from ..ops.prefilter_dense import device_prefilter_arrays
            # the kernels on a card, their plain versions on the CPU when
            # asked for; the composition bias in one native call (None),
            # as the host walk computes it; the hits come back as host
            # arrays, one run of them per _BATCH_CHUNK keys, as the batch
            # prefilter's
            _require_card(params, "the dense prefilter "
                                  "(--prefilter-engine device)")
            device = params.device
            log(2, f"dense device prefilter ({device}): "
                   f"{nk_total} k-mers x {t_res} target residues")
            with span("dense_pass"):
                ct, _, _, co = device_prefilter_arrays(
                    q_all, keys, None, masked[0], masked[1],
                    params.prefilter, seed_m, ungapped_m, device=device,
                    catalog=target_db)
            cand_chunks = []
            for lo in range(0, len(keys), _BATCH_CHUNK):
                hi = min(lo + _BATCH_CHUNK, len(keys))
                cand_chunks.append((keys[lo:hi], ct[co[lo]:co[hi]],
                                    co[lo:hi + 1] - co[lo]))
        elif use_batch:
            with span("host_prefilter"):
                cand_chunks = _prefilter_batch_keys()
        else:
            with span("host_prefilter"):
                cand_chunks = _keyed_chunks(keys, _run_keyed(
                    _prefilter_one, keys, n_threads,
                    len(keys) * t_res > 2e10, label="prefilter "))
        with span("engine_choice"):
            # exact candidate DP cells, vectorized over the pair arrays
            q_lens = np.diff(q_off)
            t_lens = np.diff(t_off)
            cells = 0
            for chunk, ct, co in cand_chunks:
                if len(ct) == 0:
                    continue
                qlen_pair = np.repeat(q_lens[np.asarray(chunk)],
                                      np.diff(co))
                cells += int(np.dot(qlen_pair, t_lens[ct]))
            engage = _device_engage(cells)
        count("candidate_pairs", sum(len(ct) for _, ct, _ in cand_chunks))
        count("candidate_cells", cells)
        log(2, f"candidate cells {cells} -> "
               f"{'device' if engage else 'host'} scoring engine")
        if engage:
            with span("card_scoring"):
                prot = _search_tpu(keys, t_aa, (t_flat, t_off),
                                   _joined_chunks(cand_chunks), q_all, m40,
                                   evaluer, params, catalog=target_db)
        elif batched_aln_ok:
            with span("host_align"):
                prot = _align_batch_chunks(cand_chunks)
        else:
            # per-key target lists for the per-query acceptance rules
            cand = {}
            for chunk, ct, co in cand_chunks:
                for i, k in enumerate(chunk):
                    cand[k] = ct[co[i]:co[i + 1]].tolist()

            def _align_one(qkey):
                results = align_query(q_all[qkey], cand[qkey], t_aa, m40,
                                      params.align, evaluer)
                return [r.row_fields() for r in results]
            with span("host_align"):
                prot = _run_keyed(_align_one, keys, n_threads, cells > 2e10,
                                  label="align ")
    else:
        # prefilter and alignment query by query
        with span("host_search"):
            prot = _run_keyed(_one_query, keys, n_threads,
                              len(keys) * t_res > 2e10, label="search ")

    if save_thread is not None:
        with span("save_join"):
            save_thread.join()
    return _nucl_merged(prot, query_db, target_db, params)


def _masked_target(t_aa, packed, target_db, params):
    """(masked, save_thread): the tantan-masked flat target the dense
    prefilter reads, loaded from the SetDB when persisted, else built and
    persisted on a thread (None when nothing is written; the search
    joins it before it returns)."""
    from ..ops.prefilter import (build_masked_flat, load_masked_flat,
                                 save_masked_flat)
    if target_db.path:
        masked = load_masked_flat(target_db.path, params.prefilter)
        if masked is not None:
            log(2, f"using persisted masked target in {target_db.path}")
            return masked, None
    masked = build_masked_flat(t_aa, params.prefilter, packed=packed)
    if not (target_db.path and os.access(target_db.path, os.W_OK)):
        return masked, None
    import threading
    mflat, mstarts = masked

    def _save_mask():
        try:
            save_masked_flat(mflat, mstarts, target_db.path,
                             params.prefilter)
            log(2, f"persisted masked target into {target_db.path}")
        except OSError:
            pass
    save_thread = threading.Thread(target=_save_mask, daemon=False)
    save_thread.start()
    return masked, save_thread


def _target_index(t_aa, packed, target_db, params):
    """(index, save_thread): the host walk's postings index, loaded from
    the SetDB when persisted, else built and persisted on a thread (None
    when nothing is written; the search joins it before it returns)."""
    if target_db.path:
        from ..ops.prefilter import load_target_index
        index = load_target_index(target_db.path, params.prefilter)
        if index is not None:
            log(2, f"using persisted index in {target_db.path}")
            return index, None
    index = build_target_index(t_aa, params.prefilter, packed=packed)
    if not (target_db.path and os.access(target_db.path, os.W_OK)):
        return index, None
    # auto-createindex: persist the freshly built index so every later
    # search of this SetDB mmap-loads it (the reference pays IndexBuilder
    # per prefilter run unless the user runs createindex,
    # Prefiltering.cpp:734; here first use = once). The ~200 MB of .npy
    # writes ride a background thread (joined before return).
    import threading
    from ..ops.prefilter import save_target_index

    def _save():
        try:
            save_target_index(index, target_db.path, params.prefilter)
            log(2, f"persisted index into {target_db.path}")
        except OSError:
            pass
    save_thread = threading.Thread(target=_save, daemon=False)
    save_thread.start()
    return index, save_thread


# Exact candidate DP cells above which `auto` sends a search on a card to
# the GPU scoring engine. chip_smoke.py phase 3(b) on an NVIDIA H100 80GB
# HBM3 (700 W power limit) timed the search stage of both engines under
# `auto` (host prefilter, the control search forked onto the host),
# alternating fresh processes, medians, the GPU engine scoring the
# candidate pairs alone (B1's pair-list entry) with each query's
# composition bias built beside its profile on the card
# (csrc/pair_profile.cu) and torch imported on a thread beside the host
# walk: at the phase-3 corpus (82,039,218 candidate cells) GPU engine
# 11.100 s, host engine 5.134 s; its query side ten times over
# (820,392,180) 20.976 s and 14.516 s; thirty times over (2,461,176,540)
# 48.733 s and 43.693 s. Lines fitted through the three: GPU engine
# 8.9961 s + 1.6001e-8 s per cell, host engine 2.64903 s + 1.6469e-8 s
# per cell. Per cell the GPU engine is now the cheaper by 3 %, but its
# fixed cost is 6.3 s higher (the part of import torch the walk does not
# hide, 3.0-3.7 s at phase 3's shape, and the import's contention with
# the walk), so the lines cross only at 1.36e10 cells, outside the
# measured shapes; at 3x the target genomes (240,134,098 cells) the GPU
# engine also lost, 13.488 s against 8.367 s. The threshold therefore
# stays above every measured shape: `auto` keeps the host engine, and
# --use-tpu 1 still forces the GPU engine.
_DEVICE_CELLS_THRESHOLD = 1e12

# Queries per native batch-driver dispatch: bounds the transient hit
# lists and gives the Progress bar tick granularity.
_BATCH_CHUNK = 16384

# Cell budget of one [key-block, union] candidate score matrix in
# _search_tpu (~200 MB of int32 at the default). Catalog-scale searches
# stream key blocks through the engine instead of materializing an
# all-keys matrix.
_MAX_MATRIX_CELLS = 5e7


def _run_keyed(fn, keys, n_threads, big: bool, label=None) -> dict:
    """Run fn(key) for every key, fork-pooled when `big` (workers share
    the index read-only via COW, like the reference's OpenMP threads
    over a shared mmap'd index, Prefiltering.cpp:776-800). A label
    attaches Debug::Progress-style feedback for long stages."""
    from ..logging import Progress
    prog = Progress(total=len(keys), label=label) if label else None
    if big and n_threads > 1 and len(keys) > 16:
        import multiprocessing as mp
        global _worker_fn
        _worker_fn = fn
        ctx = mp.get_context("fork")
        _join_torch_probe()
        # many small chunks streamed with imap: load-balances uneven
        # queries and lets the parent tick progress as results land
        csize = max(1, min(256, len(keys) // (n_threads * 8)))
        chunks = [keys[i:i + csize] for i in range(0, len(keys), csize)]
        out = {}
        with ctx.Pool(n_threads) as pool:
            for chunk, rows_list in zip(chunks,
                                        pool.imap(_run_chunk, chunks)):
                for qkey, rows in zip(chunk, rows_list):
                    out[qkey] = rows
                if prog:
                    prog.update(len(chunk))
        if prog:
            prog.done()
        return {k: out[k] for k in keys}
    out = {}
    for k in keys:
        out[k] = fn(k)
        if prog:
            prog.update()
    if prog:
        prog.done()
    return out


def _nucl_merged(prot: dict, query_db: SetDB, target_db: SetDB,
                 params: PredictParams) -> dict:
    """_nucl_merge in the span nucl_merge, the rows it takes counted in
    protein_rows and those it returns in result_rows."""
    count("protein_rows", sum(len(rows) for rows in prot.values()))
    with span("nucl_merge"):
        out = _nucl_merge(prot, query_db, target_db, params)
    count("result_rows", sum(len(rows) for rows in out.values()))
    return out


def _nucl_merge(prot: dict, query_db: SetDB, target_db: SetDB,
                params: PredictParams) -> dict:
    """Optional nucleotide re-alignment merge (proteinaln2nucl +
    combineprotnuclaln, data/predictmatch.sh:37-45)."""
    if not params.perform_nucl_aln:
        return prot

    # nucl sequences only for queries that HAVE rows (at catalog scale
    # almost all queries have none; gathering all 10^5+ is pure waste)
    with span("nucl_gather"):
        q_nucl = query_db.orf_nucl_batch(
            [k for k, rows in prot.items() if rows])
        t_nucl = target_db.orf_nucl_batch(
            {int(r[0]) for rows in prot.values() for r in rows})
        nucl_ev = EvalueComputer(
            gumbel_params("nucleotide.out", params.nucl_gap_open,
                          params.nucl_gap_extend),
            int(np.diff(target_db.orf_nucl_offsets).sum()))
    with span("nucl_align"):
        nucl = protein_aln_to_nucl(prot, q_nucl, t_nucl, nucl_ev,
                                   params.nucl_gap_open,
                                   params.nucl_gap_extend)
    with span("nucl_combine"):
        return combine_prot_nucl(prot, nucl)


def _search_split(t_aa, packed, params, m40, enumerator, evaluer,
                  bias80_all, q_all, keys):
    """RAM-bounded target-split search: the target DB streams through
    index shards sized to the split-memory limit; per-query collect_all
    hit lists merge into the global list before alignment. The
    setupSplit / mergeTargetSplits analog (Prefiltering.cpp:258,
    Prefiltering.h:49)."""
    from ..ops.prefilter import (PrefilterHit, merge_split_hits,
                                 prefilter_query_batch,
                                 ungapped_profile_cap)

    t_flat, t_off = packed
    limit_b = params.prefilter.split_memory_limit << 20
    chunk_res = max(limit_b // 16, 1 << 18)
    bounds = [0]
    acc = 0
    for i, t in enumerate(t_aa):
        acc += len(t)
        if acc >= chunk_res:
            bounds.append(i + 1)
            acc = 0
    if bounds[-1] != len(t_aa):
        bounds.append(len(t_aa))
    log(2, f"target split mode: {len(bounds) - 1} shards")

    seed_m = load_matrix(params.prefilter.seed_matrix, 8.0)
    ungapped_m = load_matrix(params.prefilter.ungapped_matrix, 2.0)
    all_hits = {k: [] for k in keys}
    for ci in range(len(bounds) - 1):
        lo, hi = bounds[ci], bounds[ci + 1]
        sub_starts = np.ascontiguousarray(t_off[lo:hi + 1] - t_off[lo],
                                          dtype=np.int64)
        sub_flat = t_flat[t_off[lo]:t_off[hi]]
        index = build_target_index(t_aa[lo:hi], params.prefilter,
                                   packed=(sub_flat, sub_starts))
        for blo in range(0, len(keys), _BATCH_CHUNK):
            chunk = keys[blo:blo + _BATCH_CHUNK]
            hls = prefilter_query_batch(
                [q_all[k] for k in chunk], index, params.prefilter,
                seed_m, ungapped_m, enumerator=enumerator,
                bias80_all=[bias80_all[k] for k in chunk],
                collect_all=True)
            for k, hl in zip(chunk, hls):
                all_hits[k].extend(
                    PrefilterHit(h.target + lo, h.score, h.diagonal)
                    for h in hl)
        del index
    from ..ops.prefilter import release_postings_scratch
    release_postings_scratch()  # per-shard indexes are done; RAM back

    merged_cand = {}
    for k in keys:
        _, cap = ungapped_profile_cap(q_all[k], bias80_all[k], ungapped_m)
        merged = merge_split_hits(all_hits[k], cap, params.prefilter)
        merged_cand[k] = [h.target for h in merged]
    from ..ops.align import align_query_batch
    prot = {}
    for blo in range(0, len(keys), _BATCH_CHUNK):
        chunk = keys[blo:blo + _BATCH_CHUNK]
        res = align_query_batch(
            [q_all[k] for k in chunk], [merged_cand[k] for k in chunk],
            t_flat, t_off, m40, params.align, evaluer, as_rows=True)
        for k, rows in zip(chunk, res):
            prot[k] = rows
    return prot


# The torch probe of this process, once started: (thread, its result
# {"present": bool, or the exception it raised; "seconds": its time}).
_torch_probe = None


def _start_torch_probe():
    """Import torch, probe for a card and create its CUDA context on a
    thread, at most once per process (search_setdbs starts it before the
    host prefilter walk of a search that could go to the card)."""
    global _torch_probe
    if _torch_probe is not None:
        return
    import threading
    import time
    result = {}

    def probe():
        t0 = time.perf_counter()
        try:
            import torch
            result["present"] = torch.cuda.is_available()
            if result["present"]:
                torch.zeros(1, device="cuda")   # the CUDA context
        except BaseException as exc:  # noqa: BLE001 - re-raised on join
            result["present"] = exc
        result["seconds"] = time.perf_counter() - t0

    thread = threading.Thread(target=probe, name="torch-probe")
    thread.start()
    _torch_probe = (thread, result)


def _join_torch_probe() -> float:
    """Wait for the torch probe thread, if one was started; the seconds
    waited. Every fork waits for it first: a child forked while it
    imports could inherit a held import lock or a half-made CUDA
    context."""
    if _torch_probe is None or not _torch_probe[0].is_alive():
        return 0.0
    import time
    t0 = time.perf_counter()
    with span("torch_probe_wait"):
        _torch_probe[0].join()
    return time.perf_counter() - t0


def _accelerator_present() -> bool:
    """Whether a CUDA card is attached: the torch probe's answer when it
    was started (joined here, its wait logged the first time), else a
    direct probe."""
    if _torch_probe is not None:
        waited = _join_torch_probe()
        result = _torch_probe[1]
        if "waited" not in result:
            result["waited"] = waited
            log(2, f"torch probe: import, card probe and CUDA context "
                   f"{result['seconds']:.3f} s on a thread; the search "
                   f"waited {waited:.3f} s for it")
        if isinstance(result["present"], BaseException):
            raise result["present"]
        return result["present"]
    import torch
    return torch.cuda.is_available()


def _keyed_chunks(keys, cand: dict) -> list:
    """Per-key candidate lists as the batch prefilter's raw arrays:
    [(chunk_keys, cand_t int32, cand_off int64), ...] in _BATCH_CHUNK
    runs of keys."""
    import itertools
    out = []
    for lo in range(0, len(keys), _BATCH_CHUNK):
        chunk = keys[lo:lo + _BATCH_CHUNK]
        co = np.zeros(len(chunk) + 1, dtype=np.int64)
        np.cumsum([len(cand[k]) for k in chunk], out=co[1:])
        ct = np.fromiter(itertools.chain.from_iterable(
            cand[k] for k in chunk), dtype=np.int32, count=int(co[-1]))
        out.append((chunk, ct, co))
    return out


def _joined_chunks(cand_chunks):
    """One (cand_t, cand_off) pair over every chunk, keys in order."""
    cts = [ct for _, ct, _ in cand_chunks]
    offs = [np.zeros(1, dtype=np.int64)]
    base = 0
    for _, ct, co in cand_chunks:
        offs.append(np.asarray(co[1:], dtype=np.int64) + base)
        base += int(co[-1])
    cand_t = (np.concatenate(cts).astype(np.int64) if cts
              else np.zeros(0, dtype=np.int64))
    return cand_t, np.concatenate(offs)


# Padded positions per local_aa_bias_batch call in _query_bias_i8: its
# [block, longest, alphabet] float64 table stays near 11 MB.
_BIAS_BLOCK_CELLS = 1 << 16


def _query_bias_i8(q_list, matrix) -> list:
    """sw_bias_i8 of every query (ops/align.py): local_aa_bias_batch over
    length-sorted blocks of at most _BIAS_BLOCK_CELLS padded positions
    (one long ORF pads only its own block), rounded half away from zero
    as sw_bias_i8 rounds. Bit-identical to sw_bias_i8 per query."""
    from ..ops.bias import local_aa_bias_batch, round_half_away
    n = len(q_list)
    lens = np.fromiter((len(q) for q in q_list), dtype=np.int64, count=n)
    order = np.argsort(lens, kind="stable")
    sorted_lens = np.maximum(lens[order], 1)
    out = [None] * n
    lo = 0
    while lo < n:
        # the block [lo, hi) pads to its last (longest) query
        span = np.arange(1, min(n - lo, _BIAS_BLOCK_CELLS) + 1)
        fits = span * sorted_lens[lo:lo + len(span)] <= _BIAS_BLOCK_CELLS
        hi = lo + max(int(np.searchsorted(~fits, True)), 1)
        idx = order[lo:hi]
        for i, b in zip(idx.tolist(), local_aa_bias_batch(
                [q_list[i] for i in idx], matrix)):
            out[i] = round_half_away(b)
        lo = hi
    return out


def _key_blocks(cand_t, cand_off, max_cells) -> list:
    """[(k0, k1)] key ranges for _candidate_scores: each block closes at
    the first key where keys x distinct candidate targets exceeds
    max_cells (the last may stay under it). A pair's target is new to
    a block starting at pair p0 when its previous occurrence lies
    before p0, so each block reads a cumulative sum over a window of
    pairs that doubles until the block closes."""
    nk = len(cand_off) - 1
    n = len(cand_t)
    order = np.argsort(cand_t, kind="stable")
    prev = np.full(n, -1, dtype=np.int64)
    same = cand_t[order[1:]] == cand_t[order[:-1]]
    prev[order[1:][same]] = order[:-1][same]
    blocks = []
    s, w = 0, 64
    while s < nk:
        e = min(s + w, nk)
        p0 = int(cand_off[s])
        new = np.concatenate(([0], np.cumsum(prev[p0:cand_off[e]] < p0)))
        union = new[cand_off[s + 1:e + 1] - p0]
        n_keys = np.arange(1, e - s + 1)
        over = np.flatnonzero(n_keys * np.maximum(union, 1) > max_cells)
        if len(over) == 0 and e < nk:
            w *= 2
            continue
        end = s + int(over[0]) + 1 if len(over) else nk
        blocks.append((s, end))
        w = max(64, end - s)
        s = end
    return blocks


def _pairs_on_card(params) -> bool:
    """Whether _candidate_scores takes B1's pair-list entry on the card
    (no mesh, and the caller did not ask for the CPU)."""
    return params.mesh is None and params.device != "cpu"


def _candidate_scores(q_list, t_aa, cand_t, cand_off, biases, m40,
                      params, t_packed=None, catalog=None) -> np.ndarray:
    """Exact SW score of every (query, candidate) pair, int64 in pair
    order: B1's pair-list entry on a card (the pairs alone; t_packed =
    (t_flat, t_off), the search's packed targets, is built from t_aa when
    not given; each query's composition bias is computed with its
    profile on the card, so `biases` is not read; with `catalog`, the
    targets' SetDB, their copy on the card is kept in the resident store,
    ops/resident.py, and read there by later searches), B4 per shard on
    the mesh, the torch scan on the CPU when the caller asked for it
    (params.device). The mesh and the scan take keys in blocks whose
    dense [block, union] matrix stays within _MAX_MATRIX_CELLS: at
    catalog scale (30k+ query sets, README.md:107-110) a single all-keys
    union matrix is the memory wall, and a block's union spans only the
    targets its queries hit."""
    go, ge = params.align.gap_open, params.align.gap_extend
    if _pairs_on_card(params):
        from ..ops.bias import expected_score_tab
        from ..ops.sw_packed import device_pair_scores
        _require_card(params, "the GPU scoring engine (--use-tpu 1)")
        if t_packed is None:
            t_off = np.zeros(len(t_aa) + 1, dtype=np.int64)
            np.cumsum([len(t) for t in t_aa], out=t_off[1:])
            t_packed = (np.concatenate(t_aa) if len(t_aa)
                        else np.zeros(0, np.uint8), t_off)
        return device_pair_scores(
            q_list, None, t_packed[0], t_packed[1], cand_t, cand_off,
            m40.scores, go, ge, device="cuda",
            expected=(expected_score_tab(m40)
                      if params.align.comp_bias_corr else None),
            catalog=catalog)
    out = np.zeros(len(cand_t), dtype=np.int64)
    mesh = None
    if params.mesh is not None:
        from ..parallel.sharding import make_mesh
        # on the CUDA devices (make_mesh raises without one), or on the
        # CPU when the caller asked for it
        mesh = make_mesh(*params.mesh, devices=(
            ["cpu"] if params.device == "cpu" else None))
    t_lens = (np.diff(t_packed[1]) if t_packed is not None
              else np.fromiter((len(t) for t in t_aa), dtype=np.int64,
                               count=len(t_aa)))
    for k0, k1 in _key_blocks(cand_t, cand_off, _MAX_MATRIX_CELLS):
        p0, p1 = int(cand_off[k0]), int(cand_off[k1])
        if p0 == p1:
            continue
        union, cols = np.unique(cand_t[p0:p1], return_inverse=True)
        rows = np.repeat(np.arange(k1 - k0),
                         np.diff(cand_off[k0:k1 + 1]))
        q_blk, b_blk = q_list[k0:k1], biases[k0:k1]
        if mesh is not None:
            # kernel B4 per shard; scores come back as numpy
            from ..parallel.sharding import sharded_allpairs_scores
            with span("pair_score"):
                scores = sharded_allpairs_scores(
                    mesh, q_blk, [t_aa[t] for t in union.tolist()],
                    m40.scores, bias_list=b_blk, gap_open=go, gap_extend=ge)
            out[p0:p1] = scores[rows, cols]
        else:
            # asked for the CPU: the bucketed torch scan, pair by pair
            from ..ops.sw_tpu import score_pairs_bucketed
            q_lens = np.fromiter((len(q) for q in q_blk), dtype=np.int64,
                                 count=len(q_blk))
            count("pair_cells", int(np.dot(q_lens[rows],
                                           t_lens[cand_t[p0:p1]])))
            with span("pair_score"):
                out[p0:p1] = score_pairs_bucketed(
                    list(zip(rows.tolist(), cand_t[p0:p1].tolist())),
                    q_blk, t_aa, m40.scores, b_blk, go, ge, device="cpu")
    return out


def _evalue_screen(scores, q_lens, cand_off, evaluer, evalue_max):
    """Bool mask of the pairs whose E-value passes, vectorized over every
    pair as align_query_batch screens (ops/align.py)."""
    pair_q = np.repeat(np.arange(len(q_lens)), np.diff(cand_off))
    return evaluer.evalue(scores, q_lens[pair_q]) <= evalue_max


def _align_survivors(keys, q_list, t_packed, cand_t, cand_off, keep, m40,
                     evaluer, params) -> dict:
    """{key: rows} of the screened pairs through align_query_batch in
    _BATCH_CHUNK runs of keys: its native forward pass gives each
    survivor's end cells (the device scores carry none) and its
    traceback runs on survivors only."""
    from ..ops.align import align_query_batch
    t_flat, t_off = t_packed
    pair_q = np.repeat(np.arange(len(keys)), np.diff(cand_off))
    s_off = np.zeros(len(keys) + 1, dtype=np.int64)
    np.cumsum(np.bincount(pair_q[keep], minlength=len(keys)),
              out=s_off[1:])
    s_t = cand_t[keep]
    prot = {}
    for lo in range(0, len(keys), _BATCH_CHUNK):
        hi = min(lo + _BATCH_CHUNK, len(keys))
        co = s_off[lo:hi + 1] - s_off[lo]
        res = align_query_batch(
            q_list[lo:hi], None, t_flat, t_off, m40, params.align, evaluer,
            cand_arrays=(s_t[s_off[lo]:s_off[hi]], co), as_rows=True)
        prot.update(zip(keys[lo:hi], res))
    return prot


def _search_tpu(keys, t_aa, t_packed, cand_arrays, q_all, m40, evaluer,
                params, catalog=None):
    """Device scoring engine: candidates come from the host prefilter
    (order-dependent integer heuristics, QueryMatcher.cpp:84-323) as raw
    arrays, cand_arrays=(cand_t, cand_off) with keys[i]'s candidates at
    cand_t[cand_off[i]:cand_off[i + 1]]; the device scores every
    candidate pair (_candidate_scores), and the exact
    host alignment runs only on E-value survivors — output-identical to
    the host path (the device scores are cell-exact,
    tests/test_sw_packed.py).

    With the product's acceptance parameters the E-value screen and the
    survivors' alignment run over whole key blocks (_evalue_screen,
    _align_survivors), and on the card the composition biases are
    computed with the query profiles (csrc/pair_profile.cu); otherwise
    each key is realigned on its own, as the JAX package does,
    fork-pooled like the host path (the reference realigns accepted
    pairs omp-parallel, Alignment.cpp:255-), from host biases
    (_query_bias_i8), which the mesh and the CPU scan also read."""
    from ..ops.align import sw_align, check_criteria

    cand_t, cand_off = cand_arrays
    q_list = [q_all[k] for k in keys]
    a = params.align
    batched = (a.max_accept == INT_MAX and a.max_rejected == INT_MAX
               and a.cov_thr == 0 and a.seq_id_thr == 0
               and a.aln_len_thr == 0)
    if batched and _pairs_on_card(params):
        biases = None
    elif params.align.comp_bias_corr:
        biases = _query_bias_i8(q_list, m40)
    else:
        biases = [np.zeros(len(q), dtype=np.int64) for q in q_list]
    scores = _candidate_scores(q_list, t_aa, cand_t, cand_off, biases, m40,
                               params, t_packed=t_packed, catalog=catalog)
    if batched:
        q_lens = np.fromiter((len(q) for q in q_list), dtype=np.int64,
                             count=len(q_list))
        with span("evalue_screen"):
            keep = _evalue_screen(scores, q_lens, cand_off, evaluer,
                                  a.evalue)
        count("survivors", int(np.count_nonzero(keep)))
        with span("survivor_align"):
            return _align_survivors(keys, q_list, t_packed, cand_t,
                                    cand_off, keep, m40, evaluer, params)

    row_of = {k: i for i, k in enumerate(keys)}

    def _realign_one(qkey):
        i = row_of[qkey]
        lo, hi = int(cand_off[i]), int(cand_off[i + 1])
        out = []
        for t, sc in zip(cand_t[lo:hi].tolist(), scores[lo:hi].tolist()):
            if float(evaluer.evalue(sc, len(q_all[qkey]))) \
                    > params.align.evalue:
                continue
            res = sw_align(q_all[qkey], t_aa[t], m40, params.align, evaluer,
                           biases[i])
            if res is None:
                continue
            res.target = t
            if check_criteria(res, params.align):
                out.append(res)
        out.sort(key=lambda r: (r.evalue, -r.raw_score, r.t_len, r.target))
        return [r.row_fields() for r in out]

    n_threads = params.threads if params.threads > 0 else (os.cpu_count() or 1)
    t_lens = np.diff(t_packed[1])
    pair_q = np.repeat(np.arange(len(keys)), np.diff(cand_off))
    surv_cells = int(np.dot(np.fromiter((len(q) for q in q_list),
                                        dtype=np.int64,
                                        count=len(q_list))[pair_q],
                            t_lens[cand_t]))
    return _run_keyed(_realign_one, keys, n_threads, surv_cells > 2e9,
                      label="align ")


def _cuda_initialized() -> bool:
    import sys as _sys
    torch = _sys.modules.get("torch")
    return bool(torch is not None and torch.cuda.is_initialized())


def _fork_reverse_search(cache, query_db, control_db, params):
    """Fork a child computing the reverse-control search + aggregation
    into the cache; returns the child pid or None (sequential).

    Skipped when: the cache is in-memory (nothing to hand over), the
    artifacts already exist (resume), an explicit device request is on
    (two processes sharing one GPU context is undefined), or CUDA is
    already initialized in this process (a forked child cannot use it).
    The child forces host engines for the same reason — engine choice
    never changes output bytes."""
    if not hasattr(cache, "has") or os.name != "posix":
        return None
    if cache.has("result_rev") and cache.has("aggregate_rev"):
        return None
    if params.use_tpu or params.mesh is not None or params.trace_dir:
        return None
    _join_torch_probe()
    if _cuda_initialized():
        return None
    cache.flush()     # no writer threads may cross the fork
    pid = os.fork()
    if pid != 0:
        return pid
    status = 1
    try:
        # die with the parent: an orphaned control search must not keep
        # writing artifacts after a kill (it would race the resumed run)
        try:
            import ctypes
            import signal
            ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
            if os.getppid() == 1:
                os._exit(1)       # parent already gone
        except Exception:  # noqa: BLE001 - best-effort on non-Linux
            pass
        from dataclasses import replace
        from ..logging import set_verbosity
        set_verbosity(0)          # the parent owns the terminal
        p_host = replace(params, use_tpu=False, mesh=None, trace_dir=None,
                         prefilter=replace(params.prefilter,
                                           engine="host"))
        rev = search_setdbs(query_db, control_db, p_host)
        cache.save("result_rev", rev)
        cache.save("aggregate_rev",
                   _aggregate_chain(rev, query_db, control_db))
        status = 0
    except BaseException:       # noqa: BLE001 - parent recomputes
        pass
    finally:
        os._exit(status)


def _aggregate_chain(result: dict, query_db: SetDB, target_db: SetDB):
    """besthitperset -> mergeresultsbyset -> combinescore, in the span
    aggregation."""
    with span("aggregation"):
        return _aggregate(result, query_db, target_db)


def _aggregate(result, query_db, target_db):
    t_m2s = target_db.orf_to_set
    t_sizes = target_db.set_size
    with span("besthitperset"):
        aggregate = {k: (best_hit_per_set(rows, t_m2s, t_sizes) if rows
                         else [])
                     for k, rows in result.items()}
    with span("mergeresultsbyset"):
        q_m2s = query_db.orf_to_set
        set_to_members = {}
        for okey in range(query_db.n_orfs):
            set_to_members.setdefault(int(q_m2s[okey]), []).append(okey)
        merged = merge_results_by_set(aggregate,
                                      dict(sorted(set_to_members.items())))
    with span("combinescore"):
        cscore = {qset: combine_score(rows, int(query_db.set_size[qset]),
                                      t_m2s)
                  for qset, rows in merged.items()}
    return aggregate, merged, cscore


@contextlib.contextmanager
def _traced_call(trace_dir: str):
    """torch.profiler over the block (CPU, plus CUDA when a GPU is
    attached) with the program's spans recorded (logging.recording);
    writes <trace_dir>/predictmatch.trace.json, the chrome trace, and
    <trace_dir>/spans.json, every span's record on the trace's clock and
    the counters' totals over the block."""
    import torch
    from ..logging import recording
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof, \
            recording() as rec:
        yield
    trace = os.path.join(trace_dir, "predictmatch.trace.json")
    prof.export_chrome_trace(trace)
    rec.write(os.path.join(trace_dir, "spans.json"), trace)


@dataclass
class PredictResult:
    text: str
    match: dict
    cscore: dict
    cscore_rev: dict
    aln_merged: dict
    aggregate: dict
    truncated: dict
    messages: list
    lca_tsv: Optional[str] = None
    lca_per_target_tsv: Optional[str] = None


def predict_match(query_db: SetDB, target_db: SetDB, control_db: SetDB,
                  params: Optional[PredictParams] = None,
                  taxonomy=None, cache=None,
                  dump_stages: Optional[str] = None) -> PredictResult:
    """The whole call, in the span predict_match; with params.trace_dir,
    profiled and its spans recorded (_traced_call)."""
    params = params or PredictParams()
    traced = (_traced_call(params.trace_dir) if params.trace_dir
              else contextlib.nullcontext())
    with traced, span("predict_match"):
        return _predict_match(query_db, target_db, control_db, params,
                              cache, dump_stages)


def _predict_match(query_db, target_db, control_db, params, cache,
                   dump_stages):
    from ..logging import stage_timer
    from .workflow import NullCache

    cache = cache or NullCache()

    # Step-granular resume (SURVEY 5.4): every stage below the two
    # searches is its own cached artifact, mirroring the reference's
    # per-step notExists guards (data/predictmatch.sh:29-230) — killing
    # a run and restarting recomputes only the first missing stage.
    # The forward and reverse-control searches are independent until
    # the FDR calibration, so the control side runs CONCURRENTLY in a
    # forked child writing its cache artifacts (the reference gets its
    # 2-core utilization from OpenMP inside each stage; here the
    # single-threaded Python stages of the two searches overlap each
    # other instead). Resume-safe: the child writes via the atomic
    # tmp+rename protocol; if it dies, the parent recomputes in-process.
    rev_pid = _fork_reverse_search(cache, query_db, control_db, params)

    with stage_timer("search"):
        search_result = cache.get_or_compute(
            "result", lambda: search_setdbs(query_db, target_db, params))
    aggregate, merged, cscore = cache.get_or_compute(
        "aggregate", lambda: _aggregate_chain(search_result, query_db,
                                              target_db))

    if rev_pid is not None:
        with span("control_wait"):
            try:
                os.waitpid(rev_pid, 0)
            except ChildProcessError:
                pass

    # result_rev is only needed by the aggregation (and the optional
    # stage dumps) — when the child already wrote aggregate_rev, the
    # big reverse row table is never deserialized at all
    _rev_memo = []

    def _get_result_rev():
        if not _rev_memo:
            _rev_memo.append(cache.get_or_compute(
                "result_rev",
                lambda: search_setdbs(query_db, control_db, params)))
        return _rev_memo[0]

    with stage_timer("search_rev"):
        cscore_rev = cache.get_or_compute(
            "aggregate_rev",
            lambda: _aggregate_chain(_get_result_rev(), query_db,
                                     control_db))[2]

    with span("fdr"):
        match, messages = cache.get_or_compute(
            "match", lambda: filter_match_by_fdr(cscore, cscore_rev,
                                                 params.fdr,
                                                 params.report_fdr))

    def _aln_stage():
        q_sizes = np.asarray(query_db.set_size)[query_db.orf_to_set]
        q_set_size_of = {okey: int(q_sizes[okey])
                         for okey in range(query_db.n_orfs)}
        truncated = truncate_best_hits(aggregate, q_set_size_of)
        offset = offset_alignments(truncated, query_db, target_db)
        with_tax = target_db.contig_taxid is not None
        aln = convert_alignments(offset, query_db, target_db, with_tax)
        set_to_contigs = {}
        for c in range(query_db.n_contigs):
            set_to_contigs.setdefault(
                int(query_db.contig_to_set[c]), []).append(c)
        aln_merged = merge_entries_by_set(aln, set_to_contigs)
        if params.report_pam:
            aln_merged = find_pam(aln_merged, target_db)
        return truncated, aln_merged

    with span("alignments"):
        truncated, aln_merged = cache.get_or_compute("aln", _aln_stage)

    with span("report"):
        text = summarize_results(match, aln_merged, params.fmt,
                                 params.report_fdr, taxonomy=None)
    result = PredictResult(text, match, cscore, cscore_rev, aln_merged,
                           aggregate, truncated, messages)

    if dump_stages:
        # entry-TSV snapshots of every stage table, consumable by the
        # expert subcommands (the tmp-DB analog of predictmatch.sh)
        from ..io.entries_tsv import write_entries
        os.makedirs(dump_stages, exist_ok=True)
        stage_tables = {
            "result": search_result, "result_rev": _get_result_rev(),
            "aggregate": aggregate, "merged": merged, "cscore": cscore,
            "cscore_rev": cscore_rev, "match": match, "truncated": truncated,
            "aln": aln_merged,
        }
        for name, table in stage_tables.items():
            write_entries(table, os.path.join(dump_stages, name + ".tsv"))

    with span("taxonomy"):
        _taxonomy_reports(result, truncated, cscore, cscore_rev, query_db,
                          target_db, params)

    cache.flush()   # join background artifact writers (resume-durable)
    return result


def _taxonomy_reports(result, truncated, cscore, cscore_rev, query_db,
                      target_db, params):
    """The LCA reports (data/predictmatch.sh:170-230) into
    result.lca_tsv and result.lca_per_target_tsv, where the DBs carry
    taxonomy."""
    from ..tax.lcasteps import (aggregate_tax, majority_lca_per_target,
                                per_orf_lca, restrict_ranks)
    from ..tax.ncbi import DEFAULT_RANKS, load_taxonomy

    ranks = DEFAULT_RANKS.split(",")
    if target_db.orf_taxid is not None and target_db.taxdump_path:
        taxonomy = load_taxonomy(target_db.taxdump_path)
        blacklist = taxonomy.parse_blacklist()
        orf_lca = per_orf_lca(truncated, target_db.orf_taxid, taxonomy,
                              ranks, blacklist)
        members_by_spacer = {}
        for okey in range(query_db.n_orfs):
            members_by_spacer.setdefault(
                int(query_db.orf_contig[okey]), []).append(okey)
        spacer_lca = aggregate_tax(orf_lca, members_by_spacer, taxonomy, ranks)
        lines = []
        for ckey in sorted(spacer_lca.keys()):
            lines.append(query_db.contig_accession[ckey] + "\t"
                         + "\t".join(spacer_lca[ckey]))
        result.lca_tsv = "\n".join(lines) + ("\n" if lines else "")

    if query_db.set_taxid is not None and query_db.taxdump_path:
        taxonomy = load_taxonomy(query_db.taxdump_path)
        blacklist = taxonomy.parse_blacklist()
        match_tax, _ = filter_match_by_fdr(cscore, cscore_rev, params.tax_fdr)
        match_swapped = {}
        for qset in sorted(match_tax.keys()):
            for row in match_tax[qset]:
                match_swapped.setdefault(int(row[0]), []).append(
                    [str(qset), row[1], row[2]])
        per_target = majority_lca_per_target(
            match_swapped, query_db.set_taxid, taxonomy, ranks, blacklist)
        if params.restrict_ranks_mode:
            per_target = restrict_ranks(per_target, match_swapped, taxonomy,
                                        ranks, params.rank_min_seq_ids)
        lines = []
        for tset in sorted(per_target.keys()):
            lines.append(target_db.set_names[tset] + "\t"
                         + "\t".join(per_target[tset]))
        result.lca_per_target_tsv = "\n".join(lines) + ("\n" if lines else "")
