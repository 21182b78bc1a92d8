"""The port's search modes off the default path, on the golden run's
inputs (rebuilt by test_torch_cli's `golden_fastas`): RAM-bounded target
splits, the iterative sensitivity loop (sens_steps), and step-granular
resume through WorkflowCache. Each is held against the port's default
run, the JAX package on the same inputs, or the golden bytes."""
import glob
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from spacepharer_tpu.io.setdb import build_setdb_from_fasta as jax_fasta
from spacepharer_tpu.io.setdb import build_setdb_from_spacers as jax_spacers
from spacepharer_tpu.io.spacer_formats import parse_spacers as jax_parse
from spacepharer_tpu.pipeline import predictmatch as jax_pm
from spacepharer_tpu_torch.io.setdb import (build_setdb_from_fasta,
                                            build_setdb_from_spacers)
from spacepharer_tpu_torch.io.spacer_formats import parse_spacers
from spacepharer_tpu_torch.pipeline import predictmatch as pm
from spacepharer_tpu_torch.pipeline.workflow import WorkflowCache
from test_torch_cli import golden_fastas, run_launcher  # noqa: F401

SPLIT_COPIES = 4      # mutated copies of each golden genome (split mode)


def _query_db(parse, build, spacers):
    return build(*parse(spacers))


@pytest.fixture(scope="module")
def dbs(golden_fastas):  # noqa: F811
    """(query, target, control) SetDBs of the port."""
    _, genomes, spacers = golden_fastas
    return (_query_db(parse_spacers, build_setdb_from_spacers, spacers),
            build_setdb_from_fasta(genomes),
            build_setdb_from_fasta(genomes, reverse_fragments=True))


def _host(**kw):
    return pm.PredictParams(perform_nucl_aln=False, threads=1,
                            use_tpu=False, **kw)


# ------------------------------------------------------------- split mode

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


@pytest.fixture(scope="module")
def split_target(dbs, tmp_path_factory):
    """SPLIT_COPIES 2 %-mutated copies of each golden genome, one FASTA
    each (numpy seed 0): the port's and the JAX package's target SetDBs."""
    _, tdb, _ = dbs
    d = tmp_path_factory.mktemp("split_target")
    rng = np.random.default_rng(0)
    files = []
    for c in range(tdb.n_contigs):
        acc = tdb.contig_accession[c]
        for ci in range(SPLIT_COPIES):
            path = str(d / f"{acc}_mut{ci}.fna")
            with open(path, "wb") as fh:
                fh.write(f">{acc}_mut{ci} mutated copy {ci}\n".encode()
                         + _mutate(tdb.contig_seq(c), 0.02, rng).tobytes()
                         + b"\n")
            files.append(path)
    return build_setdb_from_fasta(files), jax_fasta(files)


def test_split_search_end_to_end_parity(dbs, split_target, golden_fastas,
                                        monkeypatch):  # noqa: F811
    """A 1 MB split-memory limit cuts a target of more than 2^18 residues
    into at least two index shards; the rows equal the monolithic run's
    and the JAX package's split run's."""
    qdb = dbs[0]
    tdb, jax_tdb = split_target
    assert tdb.orf_aa_offsets[-1] > 1 << 18
    mono = pm.search_setdbs(qdb, tdb, _host())
    split = _host()
    split.prefilter.split_memory_limit = 1
    shards = []
    orig = pm.build_target_index
    monkeypatch.setattr(pm, "build_target_index",
                        lambda t, *a, **kw: shards.append(len(t))
                        or orig(t, *a, **kw))
    got = pm.search_setdbs(qdb, tdb, split)
    assert len(shards) >= 2 and sum(shards) == tdb.n_orfs
    assert got == mono
    assert sum(len(r) for r in got.values()) > 0

    _, _, spacers = golden_fastas
    jax_split = jax_pm.PredictParams(perform_nucl_aln=False, threads=1,
                                     use_tpu=False)
    jax_split.prefilter.split_memory_limit = 1
    ref = jax_pm.search_setdbs(
        _query_db(jax_parse, jax_spacers, spacers), jax_tdb, jax_split)
    assert got == ref


# ------------------------------------------------------------- sens_steps

def test_sens_steps_early_stop_and_merge(dbs):
    qdb, tdb, _ = dbs
    rows1 = pm.search_setdbs(qdb, tdb, _host())
    stepped = _host()
    stepped.prefilter.sens_steps = 3
    stepped.prefilter.start_sens = 4.0
    rows3 = pm.search_setdbs(qdb, tdb, stepped)

    assert set(rows3.keys()) == set(rows1.keys())
    # queries satisfied at a lower sensitivity stop there; queries that
    # reach the last step (-s 5.7) see at least the single-step targets
    n_with_hits1 = sum(1 for r in rows1.values() if r)
    n_with_hits3 = sum(1 for r in rows3.values() if r)
    assert n_with_hits3 >= n_with_hits1 > 0
    for k, r1 in rows1.items():
        if len(rows3[k]) < 2:
            assert {row[0] for row in r1} <= {row[0] for row in rows3[k]}


def test_sens_steps_same_sens_equals_single(dbs):
    """start_sens == sensitivity: every step searches alike, so satisfied
    queries return exactly the single-step rows."""
    qdb, tdb, _ = dbs
    rows1 = pm.search_setdbs(qdb, tdb, _host())
    stepped = _host()
    stepped.prefilter.sens_steps = 2
    stepped.prefilter.start_sens = 5.7
    rows2 = pm.search_setdbs(qdb, tdb, stepped)
    assert any(len(r1) >= 2 for r1 in rows1.values())
    for k, r1 in rows1.items():
        if len(r1) >= 2:
            assert rows2[k] == r1


def _stepped(module, engine):
    """sens_steps=3 from -s 4 with the nucleotide merge on: the host
    engine, the device scoring engine forced on, or the dense prefilter
    (the port's device routes asked for on the CPU)."""
    p = module.PredictParams(threads=1, use_tpu={"host": False,
                                                 "use_tpu": True}.get(engine),
                             **({"device": "cpu"} if module is pm else {}))
    if engine == "dense":
        p.prefilter = module.PrefilterParams(engine="device")
    p.prefilter.sens_steps = 3
    p.prefilter.start_sens = 4.0
    return p


@pytest.mark.parametrize("engine", ["host", "use_tpu", "dense"])
def test_sens_steps_equals_jax_package(dbs, golden_fastas,  # noqa: F811
                                       engine):
    qdb, tdb, _ = dbs
    _, genomes, spacers = golden_fastas
    got = pm.search_setdbs(qdb, tdb, _stepped(pm, engine))
    ref = jax_pm.search_setdbs(_query_db(jax_parse, jax_spacers, spacers),
                               jax_fasta(genomes), _stepped(jax_pm, engine))
    assert got == ref
    assert sum(len(r) for r in got.values()) > 0


# ------------------------------------------------------------ stage resume

def test_stage_artifacts_and_selective_recompute(dbs, golden, tmp_path,
                                                 monkeypatch):
    qdb, tdb, cdb = dbs
    cache = WorkflowCache(str(tmp_path), "predictmatch", "p", [])
    res1 = pm.predict_match(qdb, tdb, cdb, cache=cache)
    with open(os.path.join(golden, "result.tsv")) as fh:
        assert res1.text == fh.read()
    for name in ("result", "result_rev", "aggregate", "aggregate_rev",
                 "match", "aln"):
        assert cache.has(name), name

    # full resume: the searches must not run again
    calls = []
    orig = pm.search_setdbs
    monkeypatch.setattr(pm, "search_setdbs",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    res2 = pm.predict_match(qdb, tdb, cdb, cache=cache)
    assert not calls
    assert res2.text == res1.text

    # delete a late artifact: only it is recomputed, searches stay cached
    os.unlink(cache.path("aln"))
    os.unlink(cache.path("match"))
    res3 = pm.predict_match(qdb, tdb, cdb, cache=cache)
    assert not calls
    assert cache.has("aln") and cache.has("match")
    assert res3.text == res1.text


def test_kill_mid_run_resumes_at_first_missing_stage(golden_fastas, golden,
                                                     tmp_path):  # noqa: F811
    """SIGKILL the launcher's easy-predict after the first search artifact
    lands; the rerun reuses it and writes the golden bytes."""
    _, genomes, spacers = golden_fastas
    for name, extra in (("targets", []),
                        ("targets_rev", ["--reverse-fragments", "1"])):
        r = run_launcher(["createsetdb"] + genomes + [name, "tmp"] + extra,
                         tmp_path)
        assert r.returncode == 0, r.stderr
    args = ["easy-predict"] + spacers + ["targets", "out.tsv", "ep_tmp",
                                         "-v", "3"]
    # the stage barrier makes the kill window deterministic: the child
    # commits the first search artifact synchronously, then pauses until
    # the SIGKILL
    env = dict(os.environ, SPACEPHARER_STAGE_BARRIER="result",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    proc = subprocess.Popen([sys.executable, "-m", "spacepharer_tpu_torch"]
                            + args, cwd=tmp_path, env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    deadline = time.time() + 240
    killed = False
    while time.time() < deadline and proc.poll() is None:
        if glob.glob(str(tmp_path / "ep_tmp" / "*" / "result.pkl")):
            proc.send_signal(signal.SIGKILL)
            killed = True
            break
        time.sleep(0.02)
    proc.wait(timeout=240)
    assert killed, "pipeline exited before committing the result artifact"
    assert not (tmp_path / "out.tsv").exists()

    r = run_launcher(args, tmp_path)
    assert r.returncode == 0, r.stderr
    assert "[resume] result: reusing cached artifact" in r.stdout
    with open(os.path.join(golden, "result.tsv")) as fh:
        assert (tmp_path / "out.tsv").read_text() == fh.read()
