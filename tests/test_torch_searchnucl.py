"""The port's blastn-mode nucleotide search (`searchnucl`) against the
reference binary's m8 bytes and against the JAX package.

tests/blastn_fixtures.tar.gz holds fix, fix2 and fix3, each with the
reference's ref.m8 and tdb.lookup, the key order in which its createdb
numbered the targets (duplicate-target tie-breaks follow those keys; see
tests/test_searchnucl_parity.py). Each search here takes the targets in
that order: in memory, or as a FASTA written in that order for the
command line.
"""
import dataclasses
import os
import subprocess
import sys
import tarfile

import pytest

from chip_smoke import write_keyed_targets
from spacepharer_tpu.pipeline.searchnucl import search_nucl as jax_search
from spacepharer_tpu_torch import cli
from spacepharer_tpu_torch.io.fasta import iter_fasta
from spacepharer_tpu_torch.pipeline.searchnucl import search_nucl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "blastn_fixtures.tar.gz")
NAMES = ["fix", "fix2", "fix3"]


@pytest.fixture(scope="module")
def fixdir(tmp_path_factory):
    """The unpacked fixtures, each with t_keyed.fasta: t.fasta in the
    reference's key order."""
    d = tmp_path_factory.mktemp("torch_blastn")
    with tarfile.open(FIXTURES) as tf:
        tf.extractall(d, filter="fully_trusted")   # the repo's own bundle
    for name in NAMES:
        write_keyed_targets(str(d / name))
    return d


def _entries(path):
    return [(e.name, e.seq) for e in iter_fasta(str(path))]


def _m8(res, q_entries):
    return "".join(h.m8_row() + "\n" for qn, _ in q_entries for h in res[qn])


@pytest.mark.parametrize("name", NAMES)
def test_m8_byte_parity(fixdir, name):
    fix = fixdir / name
    q_entries = _entries(fix / "q.fasta")
    res = search_nucl(q_entries, _entries(fix / "t_keyed.fasta"))
    assert _m8(res, q_entries) == (fix / "ref.m8").read_text()


@pytest.mark.parametrize("strand", [0, 1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_hits_match_jax_package(fixdir, name, strand):
    """Every field of every hit, raw score included, on each strand."""
    fix = fixdir / name
    q_entries = _entries(fix / "q.fasta")
    t_entries = _entries(fix / "t_keyed.fasta")
    got = search_nucl(q_entries, t_entries, strand=strand)
    ref = jax_search(q_entries, t_entries, strand=strand)
    assert list(got) == list(ref)
    assert {q: [dataclasses.astuple(h) for h in hits]
            for q, hits in got.items()} == \
        {q: [dataclasses.astuple(h) for h in hits] for q, hits in ref.items()}
    if strand == 2:
        assert any(ref.values())


@pytest.mark.parametrize("name", NAMES)
def test_cli_searchnucl_writes_ref_m8(fixdir, tmp_path, capsys, name):
    fix = fixdir / name
    out = tmp_path / "out.m8"
    assert cli.main(["searchnucl", str(fix / "q.fasta"),
                     str(fix / "t_keyed.fasta"), str(out)]) == 0
    ref = (fix / "ref.m8").read_text()
    assert out.read_text() == ref
    n_q = len(_entries(fix / "q.fasta"))
    assert (f"searchnucl: {len(ref.splitlines())} hits over {n_q} queries"
            in capsys.readouterr().out)


def test_cli_searchnucl_gap_cost_without_gumbel(fixdir, tmp_path, capsys):
    """Gap costs with no embedded Gumbel parameters exit through the
    parser with 'Invalid argument', before any search."""
    fix = fixdir / "fix"
    with pytest.raises(SystemExit) as exc:
        cli.main(["searchnucl", str(fix / "q.fasta"), str(fix / "t.fasta"),
                  str(tmp_path / "out.m8"), "--gap-open", "7"])
    assert exc.value.code == 2
    assert "no embedded Gumbel parameters" in capsys.readouterr().err
    assert not (tmp_path / "out.m8").exists()


@pytest.mark.parametrize("entry,name", [("launcher", n) for n in NAMES]
                         + [("module", "fix")])
def test_searchnucl_fresh_process(fixdir, tmp_path, entry, name):
    """`bin/spacepharer_torch searchnucl` (which runs `python3 -m
    spacepharer_tpu_torch`) on every fixture, and `python -m
    spacepharer_tpu_torch searchnucl` on one, write ref.m8 byte for
    byte."""
    fix = fixdir / name
    out = tmp_path / "out.m8"
    args = ["searchnucl", str(fix / "q.fasta"), str(fix / "t_keyed.fasta"),
            str(out)]
    env = dict(os.environ, PATH=os.path.dirname(sys.executable)
               + os.pathsep + os.environ.get("PATH", ""))
    if entry == "module":
        env["PYTHONPATH"] = REPO
        cmd = [sys.executable, "-m", "spacepharer_tpu_torch"] + args
    else:
        cmd = [os.path.join(REPO, "bin", "spacepharer_torch")] + args
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=tmp_path,
                       env=env, timeout=600)
    assert r.returncode == 0, r.stderr
    assert out.read_text() == (fix / "ref.m8").read_text()
