"""One run of one cell: set-up, the measured window, the check, the
result line. See portbench/run.py for the command and the files."""
import argparse
import contextlib
import json
import os
import sys
import time

from . import cells

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, ".cache")
# sets of each call that the check reads: this many with protospacers
# (whose other spacers match nothing, so one set covers both kinds) and
# this many without; the reference's time grows with their spacers
SAMPLE_HIT_SETS = 1
SAMPLE_OTHER_SETS = 0
# top-level module names that no run may hold once the window closed:
# the JAX package is the reference the port was made from, not the
# system under test
FORBIDDEN = ("jax", "jaxlib", "flax", "spacepharer_tpu")


def log(*msg):
    print("[portbench]", *msg, file=sys.stderr, flush=True)


def pin_environment(threads: int):
    """Fix host threads and keep every cache inside the checkout, before
    numpy or torch is imported."""
    n = str(max(int(threads), 1))
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = n
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_jit")):
        os.environ[var] = os.path.join(CACHE, sub)


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is in FORBIDDEN, compared
    whole (spacepharer_tpu_torch is not spacepharer_tpu)."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in list(modules)
                   if m.split(".")[0] in FORBIDDEN})


def predict_params(config: dict, device: str):
    """PredictParams of the configuration's `predict` settings."""
    from spacepharer_tpu_torch.ops.prefilter import PrefilterParams
    from spacepharer_tpu_torch.pipeline.predictmatch import PredictParams
    p = config["predict"]
    use_tpu = p["use_tpu"]
    return PredictParams(
        prefilter=PrefilterParams(engine=p["prefilter_engine"],
                                  max_seqs=int(p["max_seqs"]),
                                  sensitivity=float(p["sensitivity"])),
        fdr=float(p["fdr"]),
        threads=int(config["threads"]),
        use_tpu=None if use_tpu < 0 else bool(use_tpu),
        device=device)


def query_db(batch):
    from spacepharer_tpu_torch.io.setdb import build_setdb_from_spacers
    from spacepharer_tpu_torch.io.spacer_formats import SpacerRecord
    recs = [SpacerRecord(h, h, s.tobytes(), si) for h, si, s in batch.spacers]
    return build_setdb_from_spacers(recs, batch.set_names)


def sampled_keys(qdb, sets):
    import numpy as np
    return [int(k) for k in np.flatnonzero(np.isin(qdb.orf_to_set, sets))]


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    return ap.parse_args(argv)


def main(argv, setup_t0, device="cuda", root=cells.ROOT, here=HERE,
         cache=CACHE):
    """The run; `device`, `root`, `here` and `cache` stay at their
    defaults but in the CPU tests, which run the plain versions on a tiny
    cell of their own."""
    args = parse(argv)
    spec = cells.resolve(args.workload, cells.benchmark(root), here)
    config = spec["config"]
    pin_environment(config["threads"])
    import torch
    chips = int(spec["cell"]["chips"])
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        log(f"needs {chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    torch.set_num_threads(max(int(config["threads"]), 1))
    try:
        import spacepharer_tpu_torch.pipeline.predictmatch  # noqa: F401
    except ImportError as exc:
        log(f"the port cannot be imported: {exc}")
        return 4
    result, compared_lines = Run(args, spec, device, setup_t0,
                                 cache).execute()
    bad = forbidden_modules()
    if bad:
        log(f"modules loaded that the port must not load: {bad}")
        return 5
    for line in compared_lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


class Run:
    def __init__(self, args, spec, device, setup_t0, cache=CACHE):
        self.args, self.spec, self.device = args, spec, device
        self.setup_t0, self.cache = setup_t0, cache

    def execute(self):
        """(the result line's object, the compared numbers' lines)."""
        self.setup()
        record = self.window(self.args.seed, self.args.seconds,
                             bool(self.args.trace))
        from .reference import check
        t0 = time.perf_counter()
        verdict = check.check_run(record)
        log(f"check {time.perf_counter() - t0:.1f} s: {verdict['seconds']}")
        return self.result(record, verdict), verdict["lines"]

    def setup(self):
        """The catalog, its SetDBs, the parameters, and one warm call on a
        small batch of the cell's traffic (the mix's warm_sets): the
        dense pass reads the whole catalog at any batch size, so it loads
        every kernel and persists the masked targets as a full batch
        would."""
        import torch
        from spacepharer_tpu_torch import logging as plog
        from spacepharer_tpu_torch.io.setdb import SetDB
        from spacepharer_tpu_torch.pipeline import predictmatch
        from . import catalog, traffic
        args, spec = self.args, self.spec
        config, mix = spec["config"], spec["traffic"]
        plog.set_verbosity(1)
        cat = catalog.ensure(config["catalog"], int(config["threads"]), log,
                             self.cache)
        log(f"catalog ready at {time.perf_counter() - self.setup_t0:.1f} s "
            f"(built now: {cat['built']})")
        tdb = SetDB.load(cat["targets"])
        cdb = SetDB.load(cat["control"])
        genomes = catalog.Genomes(config["catalog"], stored=cat["genomes"])
        self.reference_orfs = cat["reference"]
        params = predict_params(config, self.device)

        # warm-up: one whole call on a small batch of the cell's traffic
        t_w = time.perf_counter()
        warm = traffic.make_batch(mix, args.seed, traffic.WARM_CALL, genomes,
                                  n_sets=mix["warm_sets"])
        try:
            predictmatch.predict_match(query_db(warm), tdb, cdb, params)
        except Exception as exc:   # the window counts failures; this warms
            log(f"warm call failed: {type(exc).__name__}: {exc}")
        if self.device == "cuda":
            torch.cuda.synchronize()
        log(f"warm call {time.perf_counter() - t_w:.1f} s; set-up so far "
            f"{time.perf_counter() - self.setup_t0:.1f} s")
        self.tdb, self.cdb, self.genomes, self.params = tdb, cdb, genomes, params

    def window(self, seed, seconds, trace) -> dict:
        """The measured window: whole calls on batches drawn from `seed`
        until `seconds` have passed; the record of the calls, with what
        the check reads, and the device trace's sums."""
        import torch
        from .capture import Capture
        from .trace import (CALL_SPAN, SPANS, GcClock, Wrappers, add_spans,
                            device_summary, idle_gaps, profiled)
        if self.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        wrappers = Wrappers()
        cap = Capture(wrappers, self.tdb)
        if trace:
            add_spans(wrappers)
        calls = []
        setup_s = time.perf_counter() - self.setup_t0
        gc_clock = GcClock()
        window_prof = (profiled(cpu=trace) if self.device == "cuda"
                       else contextlib.nullcontext())
        with window_prof as prof, gc_clock:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                calls.append(self._call(len(calls), seed, cap, gc_clock,
                                        trace))
            t_end = time.perf_counter()
        # the check needs one completed call: where every call of the
        # window failed, up to three more run after it, outside every
        # metric
        extra = []
        while not any(c["ok"] for c in calls + extra) and len(extra) < 3:
            extra.append(self._call(len(calls) + len(extra), seed, cap,
                                    gc_clock, False))
        wrappers.close()
        window_s = t_end - t0
        log(f"window {window_s:.1f} s: " + ", ".join(
            f"call {c['call']} {c['wall_s']:.2f} s" for c in calls))
        cuda = self.device == "cuda"
        record = dict(calls=calls, extra_calls=extra, window_s=window_s,
                      sets=sum(c["sets"] for c in calls if c["ok"]),
                      setup_s=setup_s, pair_cells=cap.pair_cells,
                      device=self.device, config=self.spec["config"],
                      targets=self.tdb, control=self.cdb,
                      genomes=self.genomes, seed=seed,
                      reference_orfs=self.reference_orfs,
                      device_kind=(torch.cuda.get_device_name(0) if cuda
                                   else "cpu"),
                      memory_peak_bytes=(torch.cuda.max_memory_allocated()
                                         if cuda else 0))
        if prof:
            names = {s for _, _, s in SPANS} | {CALL_SPAN}
            summ = device_summary(prof["prof"], names)
            record.update(busy_us=summ["busy_us"], kernels=summ["kernels"])
            if trace:
                lo = min((s for _, s, _ in summ["spans"]), default=0.0)
                hi = max((e for _, _, e in summ["spans"]), default=0.0)
                record["breakdown"] = dict(
                    device_ops=[[n, us * 1e-6] for n, us in sorted(
                        summ["kernels"].items(), key=lambda kv: -kv[1])[:10]],
                    idle_gaps=idle_gaps(summ["merged"], summ["spans"], lo, hi))
            del prof["prof"]
        if wrappers.missing:
            log(f"functions not found, their spans read nothing: "
                f"{wrappers.missing}")
        if cuda:
            torch.cuda.empty_cache()
        return record

    def _call(self, i, seed, cap, gc_clock, trace) -> dict:
        """Call i of a window: its batch, one whole predict_match, and what
        the metrics and the check read of it."""
        import torch
        from spacepharer_tpu_torch import logging as plog
        from spacepharer_tpu_torch.pipeline import predictmatch
        from . import traffic
        from .trace import CALL_SPAN
        batch = traffic.make_batch(self.spec["traffic"], seed, i, self.genomes)
        qdb = query_db(batch)
        sets = traffic.sample_sets(batch, seed, SAMPLE_HIT_SETS,
                                   SAMPLE_OTHER_SETS)
        cap.start_call(sampled_keys(qdb, sets))
        st0 = plog.timings()
        gc0 = gc_clock.seconds
        n_search0, searched0 = len(cap.searches), cap.searched
        rec = dict(call=i, sets=len(batch.set_names), sampled=sets)
        c0 = time.perf_counter()
        try:
            with (torch.profiler.record_function(CALL_SPAN) if trace
                  else contextlib.nullcontext()):
                res = predictmatch.predict_match(qdb, self.tdb, self.cdb,
                                                 self.params)
            if self.device == "cuda":
                torch.cuda.synchronize()
            rec["ok"] = True
        except Exception as exc:   # a failed call is counted
            rec["ok"] = False
            rec["error"] = f"{type(exc).__name__}: {exc}"
            log(f"call {i} failed: {rec['error']}")
            res = None
        rec["wall_s"] = time.perf_counter() - c0
        st1 = plog.timings()
        rec["stages"] = {k: st1.get(k, 0.0) - st0.get(k, 0.0) for k in st1}
        rec["gc_s"] = gc_clock.seconds - gc0
        rec["searches"] = cap.searches[n_search0:]
        # both searches returned: the card's work for the call is done
        rec["searched"] = cap.searched - searched0 >= 2
        rec["batch"] = batch
        if res is not None:
            rec["check"] = dict(qdb=qdb, match=res.match, cscore=res.cscore,
                                cscore_rev=res.cscore_rev, text=res.text,
                                cand=cap.cand, prot=cap.prot, rows=cap.rows)
        return rec

    def result(self, record, verdict) -> dict:
        spec, trace = self.spec, bool(self.args.trace)
        metrics = {}
        kind = "metrics" if trace else "end_to_end"
        for m in spec["per_layer" if trace else "end_to_end"]:
            value = cells.metric_reader(m["name"], kind=kind)(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"platform": "gpu" if self.device == "cuda" else "cpu",
               "kind": record["device_kind"],
               "count": int(spec["cell"]["chips"]),
               "memory_peak_bytes": int(record["memory_peak_bytes"])}
        if trace and "busy_us" in record:
            dev["busy_s"] = record["busy_us"] * 1e-6
            dev["window_s"] = record["window_s"]
        calls = record["calls"]
        out = {"correct": verdict["correct"],
               "attempted": len(calls),
               "failed": sum(1 for c in calls if not c["ok"]),
               "metrics": metrics, "device": dev}
        if trace and "breakdown" in record:
            out["breakdown"] = record["breakdown"]
        out["compared"] = verdict["compared"]
        return out
