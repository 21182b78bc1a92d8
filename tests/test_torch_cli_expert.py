"""The port's expert subcommands: each stage re-run through the port's
CLI from the dumped entry TSVs reproduces the pipeline's next table byte
for byte, and every dumped table equals the JAX package's dump on the
same inputs (the golden run's inputs, rebuilt by test_torch_cli's
`golden_fastas`)."""
import os

import pytest

from spacepharer_tpu.io.setdb import build_setdb_from_fasta as jax_fasta
from spacepharer_tpu.io.setdb import build_setdb_from_spacers as jax_spacers
from spacepharer_tpu.io.spacer_formats import parse_spacers as jax_parse
from spacepharer_tpu.pipeline.predictmatch import predict_match as jax_pm
from spacepharer_tpu_torch.cli import main
from spacepharer_tpu_torch.io.setdb import (build_setdb_from_fasta,
                                            build_setdb_from_spacers)
from spacepharer_tpu_torch.io.spacer_formats import parse_spacers
from spacepharer_tpu_torch.pipeline.predictmatch import predict_match
from test_torch_cli import golden_fastas  # noqa: F401 - a fixture

STAGES = ["result", "result_rev", "aggregate", "merged", "cscore",
          "cscore_rev", "match", "truncated", "aln"]


def _dbs(build_fasta, build_spacers, parse, genomes, spacers):
    recs, sources = parse(spacers)
    return (build_spacers(recs, sources), build_fasta(genomes),
            build_fasta(genomes, reverse_fragments=True))


@pytest.fixture(scope="module")
def stage_env(tmp_path_factory, golden_fastas):  # noqa: F811
    """The port's SetDBs (query and target saved for the subcommands),
    its stage dump under stages/ and final text; the JAX package's dump
    of the same inputs under jax_stages/."""
    d = tmp_path_factory.mktemp("torch_expert")
    _, genomes, spacers = golden_fastas
    qdb, tdb, cdb = _dbs(build_setdb_from_fasta, build_setdb_from_spacers,
                         parse_spacers, genomes, spacers)
    qdb.save(str(d / "qdb"))
    tdb.save(str(d / "tdb"))
    res = predict_match(qdb, tdb, cdb, dump_stages=str(d / "stages"))
    (d / "final.tsv").write_text(res.text)
    ref = jax_pm(*_dbs(jax_fasta, jax_spacers, jax_parse, genomes, spacers),
                 dump_stages=str(d / "jax_stages"))
    (d / "jax_final.tsv").write_text(ref.text)
    return d


def _stage(env, name):
    return str(env / "stages" / (name + ".tsv"))


def _read(path):
    with open(path) as fh:
        return fh.read()


# subcommand, its arguments ({name}: a dumped stage table, or the output
# for {out}; qdb, tdb: the saved SetDBs), the table it must reproduce
EXPERT_STAGES = [
    ("besthitperset", ["{result}", "tdb", "{out}"], "aggregate"),
    ("mergeresultsbyset", ["{aggregate}", "qdb", "{out}"], "merged"),
    ("combinescore", ["{merged}", "qdb", "tdb", "{out}"], "cscore"),
    ("filtermatchbyfdr", ["{cscore}", "{cscore_rev}", "{out}", "--fdr",
                          "0.05"], "match"),
    ("truncatebesthits", ["{aggregate}", "qdb", "{out}"], "truncated"),
    ("summarizeresults", ["{match}", "{aln}", "{out}"], "final"),
]


@pytest.mark.parametrize("cmd,args,want", EXPERT_STAGES,
                         ids=[s[0] for s in EXPERT_STAGES])
def test_stage_cli_reproduces_next_table(stage_env, cmd, args, want):
    out = str(stage_env / f"{cmd}.out.tsv")
    argv = [cmd]
    for a in args:
        if a == "{out}":
            argv.append(out)
        elif a.startswith("{"):
            argv.append(_stage(stage_env, a[1:-1]))
        elif a in ("qdb", "tdb"):
            argv.append(str(stage_env / a))
        else:
            argv.append(a)
    assert main(argv) == 0
    ref = (str(stage_env / "final.tsv") if want == "final"
           else _stage(stage_env, want))
    assert _read(out) == _read(ref)


@pytest.mark.parametrize("name", STAGES + ["final"])
def test_stage_table_equals_jax_package(stage_env, golden, name):
    if name == "final":
        got = _read(str(stage_env / "final.tsv"))
        assert got == _read(str(stage_env / "jax_final.tsv"))
        assert got == _read(os.path.join(golden, "result.tsv"))
    else:
        got = _read(_stage(stage_env, name))
        assert got
        assert got == _read(str(stage_env / "jax_stages" / (name + ".tsv")))


def test_reverseseqbycodon_cli(tmp_path):
    fa = tmp_path / "in.fasta"
    fa.write_text(">s1 c\nAAACCCGGGTT\n>s2\nACGTGA\n")
    out = str(tmp_path / "out.fasta")
    assert main(["reverseseqbycodon", str(fa), out]) == 0
    # 11 % 3 == 2 -> first two bases dropped, codons ACC CGG GTT reversed
    assert _read(out) == ">s1 c\nGTTCGGACC\n>s2\nTGAACG\n"


def test_empiricalpval_cli(tmp_path):
    pos = tmp_path / "pos.tsv"
    neg = tmp_path / "neg.tsv"
    pos.write_text("0\t5\t3.0\t0.9\n")
    neg.write_text("0\t6\t1.0\t0.1\n0\t7\t2.0\t0.2\n0\t8\t4.0\t0.3\n")
    out = str(tmp_path / "out.tsv")
    assert main(["empiricalpval", str(pos), str(neg), out]) == 0
    # 3 controls, 1 control >= 3.0 -> p = (3 - 2 + 0.5) / 4
    assert _read(out) == "0\t5\t3.750E-01\t0.9\n"
