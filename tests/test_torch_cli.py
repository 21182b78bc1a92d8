"""The port's command surface end to end, held against the golden bytes
and against the JAX package's CLI on the same inputs.

The reference's example inputs are rebuilt from tests/golden_run.tar.gz
(`golden_fastas`): each target contig of run/targets goes to a gzipped
FASTA named after its set, each spacer of the query SetDB to the .fas
file of its set. From these files `createsetdb` + `easy-predict` must
give the golden run/result.tsv byte for byte.
"""
import filecmp
import gzip
import os
import shutil
import subprocess
import sys

import pytest

from chip_smoke import write_sets
from spacepharer_tpu import cli as jax_cli
from spacepharer_tpu_torch import cli
from spacepharer_tpu_torch.io.setdb import SetDB
from test_torch_predictmatch import _golden_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCHER = os.path.join(REPO, "bin", "spacepharer_torch")
SPACERS = ("CP003088.fas", "JNGQ01000029.fas")


@pytest.fixture(scope="session")
def golden_fastas(golden, tmp_path_factory):
    """The golden run's inputs as files: the three genome FASTAs
    (gzipped, as their .fna.gz names say) and the two spacer files.
    Returns (directory, sorted genome paths, spacer paths)."""
    d = str(tmp_path_factory.mktemp("golden_fastas"))
    write_sets(SetDB.load(os.path.join(golden, "targets")), d, gzip.open)
    write_sets(SetDB.load(_golden_paths(golden)[0]), d, open)
    genomes = sorted(os.path.join(d, f) for f in os.listdir(d)
                     if f.startswith("GCA_"))
    return d, genomes, [os.path.join(d, f) for f in SPACERS]


def run_launcher(args, cwd):
    """bin/spacepharer_torch in a fresh process, on this interpreter."""
    env = dict(os.environ, PATH=os.path.dirname(sys.executable)
               + os.pathsep + os.environ.get("PATH", ""))
    return subprocess.run([LAUNCHER] + args, capture_output=True, text=True,
                          cwd=cwd, env=env, timeout=600)


def _golden_text(golden):
    with open(os.path.join(golden, "result.tsv")) as fh:
        return fh.read()


def _same_tree(a, b, skip=()):
    """Relative paths of the files that differ between two directory
    trees (or exist in one only), files named in skip left out."""
    cmp = filecmp.dircmp(a, b, ignore=list(skip))
    out = [os.path.join(a, n) for n in cmp.left_only + cmp.right_only
           + cmp.funny_files]
    _, mismatch, errors = filecmp.cmpfiles(a, b, cmp.common_files,
                                           shallow=False)
    out += [os.path.join(a, n) for n in mismatch + errors]
    for sub in cmp.common_dirs:
        out += _same_tree(os.path.join(a, sub), os.path.join(b, sub), skip)
    return out


@pytest.fixture(scope="module")
def workdir(tmp_path_factory, golden_fastas):
    """targets and targets_rev built by the launcher's createsetdb, and
    a copy of each taken before any search persists an index into it."""
    d = tmp_path_factory.mktemp("torch_cli")
    _, genomes, _ = golden_fastas
    for name, extra in (("targets", []),
                        ("targets_rev", ["--reverse-fragments", "1"])):
        r = run_launcher(["createsetdb"] + genomes + [name, "tmp"] + extra,
                         d)
        assert r.returncode == 0, r.stderr
        shutil.copytree(d / name, d / "built" / name)
    return d


@pytest.mark.parametrize("name,extra", [
    ("targets", []), ("targets_rev", ["--reverse-fragments", "1"])])
def test_createsetdb_equals_jax_package(workdir, golden_fastas, tmp_path,
                                        name, extra):
    """Every file of the port's SetDB equals the JAX package's on the same
    FASTAs, but the stamp (a hash of the flags and of the inputs' paths,
    sizes and times)."""
    _, genomes, _ = golden_fastas
    ref = str(tmp_path / name)
    assert jax_cli.main(["createsetdb"] + genomes
                        + [ref, str(tmp_path / "tmp"), "-v", "0"]
                        + extra) == 0
    got = str(workdir / "built" / name)
    assert sorted(os.listdir(got)) == sorted(os.listdir(ref))
    assert _same_tree(got, ref, skip=["createsetdb.stamp"]) == []
    assert SetDB.load(got).is_control == bool(extra)


def test_createsetdb_exists_guard(golden_fastas, tmp_path):
    _, genomes, _ = golden_fastas
    cmd = ["createsetdb"] + genomes + ["targets", "tmp"]
    r = run_launcher(cmd, tmp_path)
    assert r.returncode == 0 and "[resume]" not in r.stdout
    r = run_launcher(cmd, tmp_path)
    assert r.returncode == 0 and "up to date [resume]" in r.stdout
    # changed params -> rebuild
    r = run_launcher(cmd + ["--min-length", "60"], tmp_path)
    assert r.returncode == 0 and "[resume]" not in r.stdout
    assert SetDB.exists(str(tmp_path / "targets"))


def test_createsetdb_progress_lines(golden_fastas, tmp_path):
    """Progress feedback on stderr at the default verbosity, none at -v 0."""
    _, genomes, _ = golden_fastas
    r = run_launcher(["createsetdb"] + genomes + ["t1", "tmp"], tmp_path)
    assert r.returncode == 0
    assert "items" in r.stderr
    r = run_launcher(["createsetdb"] + genomes + ["t2", "tmp", "-v", "0"],
                     tmp_path)
    assert r.returncode == 0
    assert "items" not in r.stderr


def test_easy_predict_golden_and_resume(workdir, golden_fastas, golden):
    _, _, spacers = golden_fastas
    r = run_launcher(["easy-predict"] + spacers
                     + ["targets", "out.tsv", "tmp", "-v", "2"], workdir)
    assert r.returncode == 0, r.stderr
    text = (workdir / "out.tsv").read_text()
    assert text == _golden_text(golden)
    hits = [ln for ln in text.split("\n") if ln.startswith(">")]
    assert sum(1 for ln in hits if float(ln.split("\t")[2]) < 1e-3) == 6
    # a second run into the same tmp dir reuses every stage artifact
    r2 = run_launcher(["easy-predict"] + spacers
                      + ["targets", "out2.tsv", "tmp", "-v", "3"], workdir)
    assert r2.returncode == 0, r2.stderr
    assert "[resume]" in r2.stdout
    assert (workdir / "out2.tsv").read_text() == text


_PARSED = ("", ".index", ".dbtype", "_h", "_h.index", "_h.dbtype",
           ".lookup", ".source", ".spacers.tsv", ".sources.tsv")


@pytest.fixture(scope="module")
def parsed(workdir, golden_fastas):
    """parsespacer of both spacer files by each package: (port DB, JAX
    DB); the same input paths, so the .source files compare too."""
    _, _, spacers = golden_fastas
    r = run_launcher(["parsespacer"] + spacers + ["qdb"], workdir)
    assert r.returncode == 0, r.stderr
    assert jax_cli.main(["parsespacer"] + spacers
                        + [str(workdir / "jax" / "qdb")]) == 0
    return str(workdir / "qdb"), str(workdir / "jax" / "qdb")


def test_parsespacer_equals_jax_package(parsed):
    got, ref = parsed
    for suffix in _PARSED:
        with open(got + suffix, "rb") as a, open(ref + suffix, "rb") as b:
            assert a.read() == b.read(), f"qdb{suffix} differs"


@pytest.mark.parametrize("fmt", ["0", "2"])
def test_predictmatch_fmt_equals_jax_package(workdir, parsed, fmt):
    """parsespacer -> createsetdb -> predictmatch --fmt N: the port's text
    equals the JAX package's chain on its own DBs."""
    qdb, jax_qdb = parsed
    jd = workdir / "jax"
    qset = f"qsetdb{fmt}"
    r = run_launcher(["createsetdb", qdb, qset, "tmp"], workdir)
    assert r.returncode == 0, r.stderr
    r = run_launcher(["predictmatch", qset, "targets", "targets_rev",
                      f"out_fmt{fmt}.tsv", f"tmp_fmt{fmt}", "--fmt", fmt],
                     workdir)
    assert r.returncode == 0, r.stderr
    assert jax_cli.main(["createsetdb", jax_qdb, str(jd / qset),
                         str(jd / "tmp"), "-v", "0"]) == 0
    assert jax_cli.main(
        ["predictmatch", str(jd / qset), str(workdir / "built" / "targets"),
         str(workdir / "built" / "targets_rev"), str(jd / f"fmt{fmt}.tsv"),
         str(jd / f"tmp_fmt{fmt}"), "--fmt", fmt, "-v", "0"]) == 0
    text = (workdir / f"out_fmt{fmt}.tsv").read_text()
    assert text == (jd / f"fmt{fmt}.tsv").read_text()
    lines = [ln for ln in text.split("\n") if ln]
    assert lines
    if fmt == "0":
        assert all(ln.startswith("#") for ln in lines)
    else:
        assert any(ln.startswith(">") for ln in lines)


def test_createindex_keeps_bytes(workdir, golden_fastas, golden, tmp_path):
    """createindex persists the JAX package's index files, and
    easy-predict over the indexed DBs still gives the golden bytes."""
    _, _, spacers = golden_fastas
    for name in ("targets", "targets_rev"):
        shutil.copytree(workdir / "built" / name, tmp_path / name)
    r = run_launcher(["createindex", "targets", "tmpidx"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert "postings" in r.stdout
    shutil.copytree(workdir / "built" / "targets", tmp_path / "jax_targets")
    assert jax_cli.main(["createindex", str(tmp_path / "jax_targets"),
                         str(tmp_path / "jax_tmp")]) == 0
    (idx,) = [n for n in os.listdir(tmp_path / "targets")
              if n.startswith("index_")]
    assert _same_tree(str(tmp_path / "targets" / idx),
                      str(tmp_path / "jax_targets" / idx)) == []
    r = run_launcher(["easy-predict"] + spacers
                     + ["targets", "out_idx.tsv", "tmp_idx", "-v", "3"],
                     tmp_path)
    assert r.returncode == 0, r.stderr
    assert "using persisted index" in r.stdout + r.stderr
    assert (tmp_path / "out_idx.tsv").read_text() == _golden_text(golden)


def test_multihit_chain_equals_jax_package(workdir, golden_fastas):
    _, genomes, _ = golden_fastas
    jd = workdir / "jax"
    steps =[["multihitdb"] + genomes[:2] + ["mhdb", "mhtmp"],
             ["multihitsearch", "mhdb", "mhdb", "mh.tsv", "mhtmp2",
              "--threads", "1"],
             ["combinepvalperset", "mh.tsv", "mhdb", "mhdb", "mhpval.tsv",
              "--aggregation-mode", "0"]]
    local = {"mhdb", "mhtmp", "mhtmp2", "mh.tsv", "mhpval.tsv"}
    for argv in steps:
        r = run_launcher(argv, workdir)
        assert r.returncode == 0, r.stderr
        assert jax_cli.main([str(jd / a) if a in local else a
                             for a in argv]) == 0
    for out in ("mh.tsv", "mhpval.tsv"):
        assert (workdir / out).read_text() == (jd / out).read_text(), out
    rows = [line.split("\t") for line in
            (workdir / "mhpval.tsv").read_text().splitlines()]
    # self-search: each set's own-set combined P-value is the strongest
    own = {r[0]: r for r in rows if r[0] == r[1]}
    assert len(own) == 2
    for qset, row in own.items():
        assert float(row[2]) <= min(float(r[2]) for r in rows
                                    if r[0] == qset)


def test_unknown_command(tmp_path):
    r = run_launcher(["bogus"], tmp_path)
    assert r.returncode == 1
    assert "Unknown command" in r.stderr


@pytest.mark.parametrize("flags", [
    ["--fdr", "1.5"], ["-s", "0.5"], ["-s", "12"], ["-k", "3"],
    ["--max-seqs", "0"], ["--threads", "-2"], ["--gap-open", "aa:x"],
    ["--sens-steps", "0"], ["-e", "-1"]])
def test_flag_value_validation(golden_fastas, tmp_path, capsys, flags):
    """Out-of-range flag values fail with 'Invalid argument' and a
    non-zero exit before any work."""
    _, _, spacers = golden_fastas
    with pytest.raises(SystemExit) as exc:
        cli.main(["easy-predict", spacers[0], str(tmp_path / "targets"),
                  str(tmp_path / "bad.tsv"), str(tmp_path / "tmp")] + flags)
    assert exc.value.code != 0
    assert "Invalid argument" in capsys.readouterr().err


def test_multiparam_syntax():
    assert cli.parse_multiparam("16,nucl:10", 16, 10) == (16, 10)
    # a bare number sets BOTH values (MultiParam.cpp:37
    # nucleotides = aminoacids)
    assert cli.parse_multiparam("12", 16, 10) == (12, 12)
    assert cli.parse_multiparam("aa:14,nucl:8", 16, 10) == (14, 8)
    assert cli.parse_multiparam("nucl:9,aa:14", 16, 10) == (14, 9)
    assert cli.parse_multiparam("nucl:9", 16, 10) == (16, 9)
    assert cli.parse_multiparam(7, 16, 10) == (7, 7)
