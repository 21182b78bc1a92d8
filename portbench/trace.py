"""Device activity from torch.profiler, and host spans around the port's
functions, opened from the benchmark's own files.

Every run profiles the window with CUDA activity (kernels, copies,
memsets from CUPTI): the union of those intervals is the card's busy
time. A `--trace 1` run adds CPU activity and `record_function` spans
around each call and around the module functions named in SPANS, wrapped
by name: a function that is no longer there is reported missing and its
span reads nothing.
"""
import contextlib
import functools
import gc
import importlib
import time

# (module, function, span): the port's functions that predict_match calls
# by module attribute, so a wrapper set on the module is the one it runs
SPANS = [
    ("spacepharer_tpu_torch.pipeline.predictmatch", "search_setdbs",
     "search"),
    ("spacepharer_tpu_torch.ops.prefilter_dense", "device_prefilter_arrays",
     "dense_prefilter"),
    ("spacepharer_tpu_torch.ops.prefilter_dense", "finalize_streams",
     "prefilter_finalize"),
    ("spacepharer_tpu_torch.pipeline.predictmatch", "_search_tpu",
     "card_scoring"),
    ("spacepharer_tpu_torch.ops.align", "align_query_batch", "host_align"),
    ("spacepharer_tpu_torch.pipeline.predictmatch", "_nucl_merge",
     "nucleotide_merge"),
    ("spacepharer_tpu_torch.pipeline.predictmatch", "_aggregate_chain",
     "aggregation"),
    ("spacepharer_tpu_torch.pipeline.predictmatch", "filter_match_by_fdr",
     "fdr"),
    ("spacepharer_tpu_torch.pipeline.predictmatch", "offset_alignments",
     "report"),
    ("spacepharer_tpu_torch.pipeline.predictmatch", "find_pam", "report"),
    ("spacepharer_tpu_torch.pipeline.predictmatch", "summarize_results",
     "report"),
]
CALL_SPAN = "predict_match"


class Wrappers:
    """Module functions replaced by wrappers for the life of the object;
    `close` puts every original back."""

    def __init__(self):
        self._saved = []
        self.missing = []

    def wrap(self, module, name, make):
        try:
            mod = importlib.import_module(module)
            orig = getattr(mod, name)
        except (ImportError, AttributeError):
            self.missing.append(f"{module}.{name}")
            return False
        self._saved.append((mod, name, orig))
        setattr(mod, name, functools.wraps(orig)(make(orig)))
        return True

    def close(self):
        for mod, name, orig in reversed(self._saved):
            setattr(mod, name, orig)
        self._saved = []


def add_spans(wrappers: Wrappers):
    import torch

    def make(span):
        def outer(orig):
            def inner(*a, **kw):
                with torch.profiler.record_function(span):
                    return orig(*a, **kw)
            return inner
        return outer
    for module, name, span in SPANS:
        wrappers.wrap(module, name, make(span))


class GcClock:
    """Seconds the collector ran, from gc.callbacks."""

    def __init__(self):
        self.seconds = 0.0
        self._t = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)
        return False


@contextlib.contextmanager
def profiled(cpu: bool):
    """torch.profiler over the block, CUDA activity always, CPU activity
    when `cpu`; yields a dict that holds the profiler once it stopped
    (under "prof")."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    out = {}
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield out
    finally:
        torch.cuda.synchronize()
        prof.stop()
        out["prof"] = prof


def _events(prof, span_names=()):
    """[(name, kind, start_us, end_us)] of every event, kind "device" (a
    kernel, copy or memset on the card) or "host". The copies of the
    benchmark's own spans that the profiler also puts on the GPU timeline
    (user annotations) are neither: they cover host time."""
    out = []
    for e in prof.events():
        tr = e.time_range
        if e.device_type.name == "CUDA":
            if getattr(e, "is_user_annotation", False) \
                    or e.name in span_names:
                continue
            kind = "device"
        else:
            kind = "host"
        out.append((e.name, kind, float(tr.start), float(tr.end)))
    return out


def union(intervals):
    """[(start, end)] merged, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def device_summary(prof, span_names=()):
    """{busy_us, kernels: {name: us}, merged: the union of the device
    intervals, spans: [(name, start, end)] of the host spans named in
    span_names} from a stopped profiler."""
    names = set(span_names)
    ev = _events(prof, names)
    dev = [(n, s, e) for n, k, s, e in ev if k == "device" and e > s]
    kernels = {}
    for n, s, e in dev:
        kernels[n] = kernels.get(n, 0.0) + (e - s)
    merged = union([(s, e) for _, s, e in dev])
    busy = sum(e - s for s, e in merged)
    spans = [(n, s, e) for n, k, s, e in ev if k == "host" and n in names]
    return dict(busy_us=busy, kernels=kernels, merged=merged, spans=spans)


def idle_gaps(merged, spans, t_lo, t_hi, top=10):
    """The longest idle gaps of the device inside [t_lo, t_hi] (us), each
    named by the innermost host span open at its middle."""
    gaps = []
    cur = t_lo
    for s, e in merged:
        if s > cur:
            gaps.append((cur, min(s, t_hi)))
        cur = max(cur, e)
    if cur < t_hi:
        gaps.append((cur, t_hi))
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:top]
    out = []
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        best = None
        for n, s, e in spans:
            if s <= mid <= e and (best is None or e - s < best[2] - best[1]):
                best = (n, s, e)
        out.append([best[0] if best else "outside_spans", (g1 - g0) * 1e-6])
    return out
