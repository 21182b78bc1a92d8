"""The check against the plain reference on the tiny cell: it passes on
the port as it is, and comes out false for the control and for the
faults the cells can have, planted under the harness."""
import numpy as np

from portbench.reference import check

PM = "spacepharer_tpu_torch.pipeline.predictmatch"
PD = "spacepharer_tpu_torch.ops.prefilter_dense"


def _window(run, seed):
    return run.window(seed, 1, False)


def test_sound_run_is_correct_and_an_altered_row_is_not(tiny_run):
    rec = _window(tiny_run, 21)
    verdict = check.check_run(rec)
    assert verdict["correct"], verdict["lines"]
    rows = rec["calls"][0]["check"]["rows"]
    key = next(k for k, v in sorted(rows.items()) if v)
    rows[key][0][3] = "1.000E-99"
    verdict = check.check_run(rec)
    assert not verdict["correct"]
    assert verdict["compared"]["final_rows"]["value"] >= 1


def test_control_is_not_correct(tiny_run):
    for seed in (31, 32):
        verdict = check.check_run(_window(tiny_run, seed), control=True)
        assert not verdict["correct"], verdict["lines"]
        assert verdict["compared"]["candidates"]["value"] >= 1


def test_half_of_the_batch_left_out(tiny_run, monkeypatch):
    import importlib
    pm = importlib.import_module(PM)
    orig = pm.search_setdbs

    def half(query_db, target_db, params, keys=None):
        return orig(query_db, target_db, params,
                    keys=list(range(0, query_db.n_orfs, 2)))
    monkeypatch.setattr(pm, "search_setdbs", half)
    verdict = check.check_run(_window(tiny_run, 41))
    assert not verdict["correct"]
    assert verdict["compared"]["candidates"]["value"] >= 1


def test_an_answer_altered_where_it_is_made(tiny_run, monkeypatch):
    import importlib
    pd = importlib.import_module(PD)
    orig = pd.device_prefilter_arrays

    def off_by_one(*a, **kw):
        t, s, d, off = orig(*a, **kw)
        return t, np.asarray(s) + 1, d, off
    monkeypatch.setattr(pd, "device_prefilter_arrays", off_by_one)
    verdict = check.check_run(_window(tiny_run, 51))
    assert not verdict["correct"]
    assert verdict["compared"]["candidates"]["value"] >= 1


def _raise_first(monkeypatch, n):
    """The FDR step raises in the first n calls (as ROADMAP C4 does)."""
    import importlib
    pm = importlib.import_module(PM)
    orig, seen = pm.filter_match_by_fdr, []

    def flaky(*a, **kw):
        seen.append(1)
        if len(seen) <= n:
            raise IndexError("list index out of range")
        return orig(*a, **kw)
    monkeypatch.setattr(pm, "filter_match_by_fdr", flaky)


def test_a_window_whose_calls_all_failed_is_checked_after_it(tiny_run,
                                                             monkeypatch):
    _raise_first(monkeypatch, 1)
    rec = _window(tiny_run, 61)
    assert [c["ok"] for c in rec["calls"]] == [False]
    assert rec["calls"][0]["searched"]
    assert [c["ok"] for c in rec["extra_calls"]] == [True]
    verdict = check.check_run(rec)
    assert verdict["correct"], verdict["lines"]
    assert verdict["compared"]["checked_calls"]["value"] == 1


def test_calls_that_never_complete_are_not_correct(tiny_run, monkeypatch):
    _raise_first(monkeypatch, 10 ** 6)
    rec = _window(tiny_run, 62)
    assert len(rec["extra_calls"]) == 3
    assert not check.check_run(rec)["correct"]


def test_a_warm_call_that_fails_leaves_the_run_standing(tiny, monkeypatch):
    import time
    from portbench import cells, harness
    _raise_first(monkeypatch, 1)
    spec = cells.resolve(tiny["workload"], cells.benchmark(tiny["root"]),
                         tiny["here"])
    args = harness.parse(["--workload", tiny["workload"], "--seed", "71",
                          "--seconds", "1", "--trace", "0"])
    run = harness.Run(args, spec, "cpu", time.perf_counter(), tiny["cache"])
    run.setup()
    rec = run.window(71, 1, False)
    assert all(c["ok"] for c in rec["calls"])
    assert check.check_run(rec)["correct"]


def _first_hit_line(rec):
    """(call, line index) of the first hit line of a sampled set."""
    for call in rec["calls"]:
        if not call.get("check"):
            continue
        names = {call["batch"].set_names[s] for s in call["sampled"]}
        cur = None
        for i, line in enumerate(call["check"]["text"].splitlines()):
            if line.startswith("#"):
                cur = line[1:].split("\t")[0]
            elif cur in names:
                return call, i
    return None, None


def test_an_altered_hit_line_is_not_correct(tiny_run):
    for seed in range(22, 30):
        rec = _window(tiny_run, seed)
        call, at = _first_hit_line(rec)
        if call is not None:
            break
    assert call is not None, "no sampled set has a hit line"
    assert check.check_run(rec)["correct"]
    lines = call["check"]["text"].splitlines()
    f = lines[at].split("\t")
    f[5] = str(int(f[5]) + 3)          # the phage start offset
    lines[at] = "\t".join(f)
    call["check"]["text"] = "\n".join(lines) + "\n"
    verdict = check.check_run(rec)
    assert not verdict["correct"]
    assert verdict["compared"]["report_sets"]["value"] == 1
