"""Logging, verbosity, and the program's spans and counters.

Parity-inspired by the reference's Debug levels 0-3 (-v flag,
lib/mmseqs/src/commons/Debug.h:46-48) and per-command wall-time
reporting (Application.cpp:36-40), with a structured twist: every span
and counter totals machine-readably in timings().

Spans (`with span(name):`) time the layers of a call: each adds its wall
seconds to timings()[name] and its self time, the seconds that no child
span on its thread covers, to timings()[name + ".self"]. stage_timer is a
span that also prints its "Time for" line. Counters (`count(name, n)`)
add to timings()[name]; a name is a span's or a counter's, never both.
Off (the default) a span reads time.perf_counter() twice and updates a
dict: no torch call, no import. Inside `with recording():` each span also
keeps a record (name, id, parent id, call id, start and end in ns on the
clock torch.profiler stamps its events with) and opens a
torch.profiler.record_function of its name when torch is imported.
"""
import itertools
import json
import re
import sys
import threading
import time

QUIET = 0
ERROR = 1
WARNING = 2
INFO = 3

_verbosity = INFO
_timings = {}       # span name (and name + ".self") -> seconds
_counts = {}        # counter name -> total
_lock = threading.Lock()
_local = threading.local()   # .stack: the spans open on this thread
_records = None     # while recording: the list span records go to
_ids = itertools.count(1)


def set_verbosity(level: int):
    global _verbosity
    _verbosity = level


def log(level: int, *msg):
    if level <= _verbosity:
        print(*msg, file=sys.stderr if level <= WARNING else sys.stdout)


def info(*msg):
    log(INFO, *msg)


def warn(*msg):
    log(WARNING, *msg)


class Progress:
    """Operator progress feedback (Debug::Progress,
    lib/mmseqs/src/commons/Debug.h:115-200): an interactive terminal
    gets an in-place bar; a non-tty stream gets '[' + one '=' per bar
    step and a closing '] N items  (t s)' line, so long createsetdb /
    search stages are visibly alive in both logs and terminals.
    Thread-safe ticks; respects the -v level (INFO and up)."""

    BARWIDTH = 65

    def __init__(self, total=None, label: str = ""):
        import threading
        self.total = total
        self.label = label
        self.n = 0
        self._printed = 0          # bar cells already emitted (non-tty)
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._last_draw = 0.0
        self._enabled = _verbosity >= INFO
        self._tty = sys.stderr.isatty()
        self._opened = False

    def update(self, n: int = 1):
        if not self._enabled:
            return
        with self._lock:
            self.n += n
            now = time.perf_counter()
            if self._tty:
                if now - self._last_draw < 0.1:
                    return
                self._last_draw = now
                if self.total:
                    frac = min(self.n / self.total, 1.0)
                    fill = int(frac * self.BARWIDTH)
                    bar = "=" * fill + (">" if fill < self.BARWIDTH else "")
                    sys.stderr.write(
                        f"\r{self.label}[{bar:<{self.BARWIDTH}}] "
                        f"{self.n}/{self.total} {frac * 100:5.1f}%")
                else:
                    sys.stderr.write(f"\r{self.label}[{self.n} items]")
                sys.stderr.flush()
            else:
                if not self._opened:
                    sys.stderr.write(self.label + "[")
                    self._opened = True
                if self.total:
                    want = int(min(self.n / self.total, 1.0) * self.BARWIDTH)
                else:
                    want = self.n // 10000
                if want > self._printed:
                    sys.stderr.write("=" * (want - self._printed))
                    sys.stderr.flush()
                    self._printed = want

    def done(self):
        if not self._enabled:
            return
        dt = time.perf_counter() - self._t0
        label = self.label
        if self._tty:
            sys.stderr.write("\r\033[K")
        elif self._opened:
            # the open bar line already carries the label
            sys.stderr.write("] ")
            label = ""
        elif self.n == 0:
            return
        sys.stderr.write(f"{label}{self.n} items  ({dt:.2f}s)\n")
        sys.stderr.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.done()
        return False


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class span:
    """with span("name"): ... — one span of the registry (the module
    docstring says what it keeps)."""

    __slots__ = ("name", "_t0", "_child", "_parent", "_rec", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self._parent = stack[-1] if stack else None
        stack.append(self)
        self._child = 0.0
        self._rec = self._rf = None
        if _records is not None:
            self._open_record(stack)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self._rec is not None:
            self._close_record()
        _stack().pop()
        if self._parent is not None:
            self._parent._child += dt
        name = self.name
        with _lock:
            if name in _counts:
                raise ValueError(f"{name!r} is a counter, not a span")
            _timings[name] = _timings.get(name, 0.0) + dt
            own = name + ".self"
            _timings[own] = _timings.get(own, 0.0) + dt - self._child
        self._report(dt)
        return False

    def _report(self, dt):
        pass

    def _open_record(self, stack):
        parent = self._parent._rec if self._parent is not None else None
        # the call: the outermost span on this thread that keeps a record
        root = next((s._rec for s in stack if s._rec is not None), None)
        rid = next(_ids)
        self._rec = rec = {
            "name": self.name, "id": rid,
            "parent": parent["id"] if parent else None,
            "call": root["id"] if root else rid,
            "start_ns": time.time_ns(), "end_ns": None}
        _records.append(rec)
        torch = sys.modules.get("torch")
        if torch is not None:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()

    def _close_record(self):
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        self._rec["end_ns"] = time.time_ns()


class stage_timer(span):
    """with stage_timer("search"): ... — a span that also reports its wall
    time at INFO."""

    __slots__ = ()

    def _report(self, dt):
        info(f"Time for {self.name}: {dt:.3f}s")


def count(name: str, n=1):
    """Add n to the counter `name` (timings()[name])."""
    with _lock:
        if name in _timings:
            raise ValueError(f"{name!r} is a span, not a counter")
        _counts[name] = _counts.get(name, 0) + n


def timings() -> dict:
    """Every span's totals and every counter's, in one dict."""
    with _lock:
        return {**_timings, **_counts}


class recording:
    """with recording() as rec: ... — span records on for the block. When
    it ends, rec.spans holds the records of the spans that closed inside
    it, and rec.counters each counter's increase over it. Not nested."""

    def __enter__(self):
        global _records
        if _records is not None:
            raise RuntimeError("recording is already on")
        with _lock:
            self._c0 = dict(_counts)
        self.spans, self.counters = [], {}
        _records = self.spans
        return self

    def __exit__(self, *exc):
        global _records
        _records = None
        self.spans = [r for r in self.spans if r["end_ns"] is not None]
        c0 = self._c0
        with _lock:
            now = dict(_counts)
        self.counters = {k: v - c0.get(k, 0) for k, v in now.items()
                         if v != c0.get(k, 0)}
        return False

    def write(self, path: str, trace: str):
        """spans.json at `path`: the records and the counters, each record
        also with ts and dur in the us of `trace`, the chrome trace that
        torch.profiler exported over the same block."""
        base = _chrome_trace_base_ns(trace)
        spans = [dict(r, ts=(r["start_ns"] - base) / 1e3,
                      dur=(r["end_ns"] - r["start_ns"]) / 1e3)
                 for r in self.spans]
        out = {"clock": "start_ns, end_ns: time.time_ns(), the clock of "
                        "torch.profiler's events",
               "base_time_ns": base, "spans": spans,
               "counters": self.counters}
        with open(path, "w") as fh:
            json.dump(out, fh)


def _chrome_trace_base_ns(path: str) -> int:
    """The ns that a chrome trace exported by torch.profiler counts its
    us timestamps from: its baseTimeNanoseconds (near the file's head), or
    0 where it has none (its timestamps are then since the epoch)."""
    with open(path, "rb") as fh:
        head = fh.read(1 << 16)
    m = re.search(rb'"baseTimeNanoseconds"\s*:\s*(\d+)', head)
    return int(m.group(1)) if m else 0
