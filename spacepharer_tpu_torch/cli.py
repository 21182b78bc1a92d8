"""spacepharer_tpu_torch command-line interface.

Mirrors the reference's product CLI (src/spacepharer.cpp:17-136):
  easy-predict, parsespacer, createsetdb, predictmatch, downloaddb
plus expert commands. Flags and defaults follow
src/commons/LocalParameters.h:167-181 and the workflow set*Defaults.

Usage:
  python -m spacepharer_tpu_torch easy-predict <spacer files...> <targetSetDB> \
      <output.tsv> <tmpDir> [flags]
  python -m spacepharer_tpu_torch createsetdb <fasta...> <outSetDB> <tmpDir> [flags]
  python -m spacepharer_tpu_torch predictmatch <querySetDB> <targetSetDB> \
      <controlSetDB> <output.tsv> <tmpDir> [flags]
  python -m spacepharer_tpu_torch parsespacer <files...|dir|.tsv> <outDB> [flags]
  python -m spacepharer_tpu_torch downloaddb <name|url-tsv> <outSetDB> <tmpDir>
"""
import argparse
import os
import sys
import time

from .io.setdb import SetDB, build_setdb_from_fasta, build_setdb_from_spacers
from .io.spacer_formats import collect_input_files, parse_spacers
from .pipeline.predictmatch import (PredictParams, predict_match,
                                    requested_device)
from .ops.align import AlnParams
from .ops.prefilter import PrefilterParams


def _ranged(kind, lo=None, hi=None, name=""):
    """Typed + range-validated argparse values — the analog of the
    reference's per-parameter regex checks (Parameters.h PARAMETER
    macros carry a regex per flag; Parameters.cpp rejects mismatches
    with 'Invalid argument'). argparse already types the token; this
    adds the value-domain check with the same failure mode (error +
    exit, not silent acceptance)."""
    def convert(text):
        try:
            v = kind(text)
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"Invalid argument: {text!r} is not "
                f"{'an integer' if kind is int else 'a number'}")
        if lo is not None and v < lo or hi is not None and v > hi:
            span = (f">= {lo}" if hi is None else
                    f"<= {hi}" if lo is None else f"in [{lo}, {hi}]")

            raise argparse.ArgumentTypeError(
                f"Invalid argument: {name or 'value'} must be {span}, "
                f"got {text}")
        return v
    return convert


def _multiparam_checked(text):
    """Validate MultiParam syntax at parse time (MultiParam.cpp:23-38
    rejects malformed dual values with 'Invalid argument')."""
    try:
        parse_multiparam(text, 0, 0)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"Invalid argument: {text!r} is not MultiParam syntax "
            "('16', 'aa:16', 'nucl:10', '16,nucl:10')")
    return text


def _add_predict_flags(p):
    p.add_argument("--fdr", type=_ranged(float, 0.0, 1.0, "--fdr"),
                   default=0.05,
                   help="FDR cutoff for filtering matches")
    p.add_argument("--tax-fdr", type=_ranged(float, 0.0, 1.0, "--tax-fdr"),
                   default=0.02,
                   help="FDR cutoff for taxonomy report")
    p.add_argument("--fmt", type=int, default=1, choices=(0, 1, 2),
                   help="0: matches, 1: +hits, 2: +nucl alignment")
    p.add_argument("--report-fdr", type=int, default=0, choices=(0, 1))
    p.add_argument("--report-pam", type=int, default=1, choices=(0, 1))
    p.add_argument("--perform-nucl-aln", type=int, default=1, choices=(0, 1))
    p.add_argument("--restrict-ranks-mode", type=int, default=1, choices=(0, 1))
    p.add_argument("--rank-min-seq-ids", type=str,
                   default="0.86,0.84,0.82,0.80,0.78,0.76,0.74,0.72")
    p.add_argument("-s", "--sensitivity",
                   type=_ranged(float, 1.0, 9.5, "-s"), default=5.7)
    p.add_argument("-k", "--kmer-size",
                   type=_ranged(int, 4, 8, "-k"), default=6)
    p.add_argument("--spaced-kmer-pattern", type=str, default="11011101")
    # default 300 = the reference's EFFECTIVE maxResListLen: its
    # "maxSequences = 1500" (PredictMatch.cpp:15) sets the clustering
    # --max-sequences member, not --max-seqs (see PrefilterParams)
    p.add_argument("--max-seqs",
                   type=_ranged(int, 1, None, "--max-seqs"), default=300)
    p.add_argument("-e", "--evalue",
                   type=_ranged(float, 0.0, None, "-e"), default=200.0)
    p.add_argument("--gap-open", type=_multiparam_checked,
                   default="16,nucl:10",
                   help="gap open cost; MultiParam aa/nucl syntax "
                        "accepted: '16', 'aa:16', '16,nucl:10'")
    p.add_argument("--gap-extend", type=_multiparam_checked,
                   default="2,nucl:2",
                   help="gap extension cost (MultiParam syntax as "
                        "--gap-open)")
    p.add_argument("--start-sens",
                   type=_ranged(float, 1.0, 9.5, "--start-sens"), default=4.0,
                   help="first sensitivity of the iterative search")
    p.add_argument("--sens-steps",
                   type=_ranged(int, 1, 32, "--sens-steps"), default=1,
                   help="number of sensitivity steps from --start-sens "
                        "to -s (queries with >= 2 alignments stop early)")
    p.add_argument("--min-ungapped-score",
                   type=_ranged(int, 0, None, "--min-ungapped-score"),
                   default=15)
    p.add_argument("--mask", type=int, default=1, choices=(0, 1))
    p.add_argument("--comp-bias-corr", type=int, default=1, choices=(0, 1))
    p.add_argument("--threads", type=_ranged(int, 0, None, "--threads"),
                   default=0, help="0 = auto")
    p.add_argument("--use-tpu", type=int, default=-1, choices=(-1, 0, 1),
                   help="score alignment candidates on the accelerator "
                        "(-1 auto: on when a device is attached and the "
                        "workload amortizes it; output-identical)")
    p.add_argument("--prefilter-engine", type=str, default="auto",
                   choices=("auto", "host", "device"),
                   help="k-mer matching engine: host index walk or dense "
                        "matching on the GPU; auto picks by workload "
                        "(output is byte-identical either way)")
    p.add_argument("--split-memory-limit",
                   type=_ranged(int, 0, None, "--split-memory-limit"),
                   default=0,
                   metavar="MB",
                   help="RAM budget for the target k-mer index; above "
                        "it the target DB streams through splits with a "
                        "per-query hit merge (0 = monolithic)")
    p.add_argument("--shards", type=str, default=None, metavar="Q,T",
                   help="device mesh for the scoring step, e.g. 2,4 = "
                        "2 query shards x 4 target shards (output is "
                        "byte-identical for any mesh shape)")
    p.add_argument("--trace-dir", type=str, default=None,
                   help="profile the whole predictmatch call and write "
                        "predictmatch.trace.json (a torch.profiler chrome "
                        "trace with the program's spans; chrome://tracing "
                        "or Perfetto) and spans.json (each span's record "
                        "on the trace's clock and the counters' totals)")
    p.add_argument("-v", "--verbosity", type=int, default=3,
                   help="0: quiet, 1: +errors, 2: +warnings, 3: +info")
    p.add_argument("--dump-stages", type=str, default=None,
                   help="write every stage table as entry TSVs to this dir "
                        "(input format of the expert subcommands)")
    p.add_argument("--force-restart", action="store_true",
                   help="ignore cached stage artifacts in tmpDir")
    p.add_argument("--remove-tmp-files", type=int, default=0, choices=(0, 1),
                   help="clear the workflow tmp dir after finishing")


def _add_createsetdb_flags(p):
    p.add_argument("-v", "--verbosity", type=_ranged(int, 0, 3, "-v"),
                   default=3,
                   help="0: quiet, 1: +errors, 2: +warnings, 3: +info")
    p.add_argument("--reverse-fragments", type=int, default=0, choices=(0, 1))
    p.add_argument("--extractorf-spacer", type=int, default=0, choices=(0, 1))
    p.add_argument("--tax-mapping-file", type=str, default=None)
    p.add_argument("--ncbi-tax-dump", type=str, default=None)
    p.add_argument("--translation-table",
                   type=_ranged(int, 1, 31, "--translation-table"),
                   default=1)
    p.add_argument("--min-length", type=_ranged(int, 1, None, "--min-length"),
                   default=None,
                   help="min ORF length in codons (default 30; spacer mode 9)")
    p.add_argument("--max-length",
                   type=_ranged(int, 1, 32734, "--max-length"),
                   default=32734)
    p.add_argument("--shuffle", type=int, default=1, choices=(0, 1),
                   help="createdb's stride-32 contig renumbering "
                        "(id-load-bearing: the reference's prefilter "
                        "hash bins and tie-breaks key on these ids)")
    p.add_argument("--threads", type=_ranged(int, 0, None, "--threads"),
                   default=0,
                   help="0 = auto (build output is deterministic and "
                        "thread-count-invariant either way, unlike the "
                        "reference's per-thread DBWriter offsets)")


def parse_multiparam(value, default_aa: int, default_nucl: int):
    """MultiParam<T> aa/nucl dual values (lib/mmseqs/src/commons/
    MultiParam.cpp:23-38): '16', 'aa:16', 'nucl:10', '16,nucl:10' or
    any comma-combination. An unprefixed number sets BOTH values
    (MultiParam.cpp:37 `nucleotides = aminoacids`); prefixed parts then
    override their side."""
    aa, nucl = default_aa, default_nucl
    for part in str(value).split(","):
        part = part.strip()
        if not part:
            continue
        if part.startswith("aa:"):
            aa = int(part[3:])
        elif part.startswith("nucl:"):
            nucl = int(part[5:])
        else:
            aa = nucl = int(part)
    return aa, nucl


def _predict_params(args) -> PredictParams:
    go_aa, go_nucl = parse_multiparam(args.gap_open, 16, 10)
    ge_aa, ge_nucl = parse_multiparam(args.gap_extend, 2, 2)
    return PredictParams(
        prefilter=PrefilterParams(
            kmer_size=args.kmer_size, spaced_pattern=args.spaced_kmer_pattern,
            sensitivity=args.sensitivity, max_seqs=args.max_seqs,
            min_diag_score=args.min_ungapped_score, mask=bool(args.mask),
            comp_bias_corr=bool(args.comp_bias_corr),
            split_memory_limit=args.split_memory_limit,
            start_sens=args.start_sens, sens_steps=args.sens_steps,
            engine=getattr(args, "prefilter_engine", "auto")),
        align=AlnParams(gap_open=go_aa, gap_extend=ge_aa,
                        evalue=args.evalue,
                        comp_bias_corr=bool(args.comp_bias_corr)),
        nucl_gap_open=go_nucl, nucl_gap_extend=ge_nucl,
        fdr=args.fdr, tax_fdr=args.tax_fdr, fmt=args.fmt,
        report_fdr=bool(args.report_fdr), report_pam=bool(args.report_pam),
        perform_nucl_aln=bool(args.perform_nucl_aln),
        restrict_ranks_mode=bool(args.restrict_ranks_mode),
        rank_min_seq_ids=tuple(float(x) for x in
                               args.rank_min_seq_ids.split(",")),
        threads=args.threads,
        use_tpu=None if args.use_tpu < 0 else bool(args.use_tpu),
        mesh=(tuple(int(x) for x in args.shards.split(","))
              if getattr(args, "shards", None) else None),
        trace_dir=getattr(args, "trace_dir", None),
        device=requested_device())


def _make_cache(tmp_dir, command, params, inputs, force_restart=False):
    from .pipeline.workflow import WorkflowCache
    import shutil
    cache = WorkflowCache(tmp_dir, command, repr(params), inputs)
    if force_restart:
        shutil.rmtree(cache.dir, ignore_errors=True)
        import os as _os
        _os.makedirs(cache.dir, exist_ok=True)
    return cache


def _write_outputs(res, out_path: str):
    with open(out_path, "w") as fh:
        fh.write(res.text)
    if res.lca_tsv is not None:
        with open(out_path + "_lca.tsv", "w") as fh:
            fh.write(res.lca_tsv)
    if res.lca_per_target_tsv is not None:
        with open(out_path + "_lca_per_target.tsv", "w") as fh:
            fh.write(res.lca_per_target_tsv)
    for msg in res.messages:
        print(msg)
    print(f"Results written to {out_path}")


def cmd_createsetdb(argv):
    p = argparse.ArgumentParser(prog="spacepharer createsetdb")
    p.add_argument("inputs", nargs="+",
                   help="FASTA files, output SetDB path, tmp dir")
    _add_createsetdb_flags(p)
    args = p.parse_args(argv)
    if len(args.inputs) < 3:
        p.error("need <fasta...> <outDB> <tmpDir>")
    from .logging import set_verbosity
    set_verbosity(args.verbosity)
    *files, out_db, tmp = args.inputs
    os.makedirs(tmp, exist_ok=True)
    t0 = time.time()
    # exists-guard resume (the reference's notExists checkpoint on the
    # workflow output, data/createsetdb.sh): same inputs + params over
    # an existing SetDB -> no-op
    from .pipeline.workflow import _hash_inputs
    stamp_params = "|".join(str(getattr(args, a)) for a in (
        "reverse_fragments", "extractorf_spacer", "min_length",
        "max_length", "translation_table", "tax_mapping_file",
        "ncbi_tax_dump", "shuffle"))
    stamp_hash = _hash_inputs("createsetdb", stamp_params, files)
    stamp_file = os.path.join(out_db, "createsetdb.stamp")
    if SetDB.exists(out_db):
        try:
            with open(stamp_file) as fh:
                if fh.read() == stamp_hash:
                    print(f"createsetdb: {out_db} up to date [resume]")
                    return 0
        except OSError:
            pass
    if len(files) == 1 and os.path.exists(files[0] + ".spacers.tsv"):
        # input is a parsespacer DB -> spacer-mode SetDB
        from .io.spacer_formats import SpacerRecord
        records = []
        with open(files[0] + ".spacers.tsv") as fh:
            for line in fh:
                _, header, fidx, seq = line.rstrip("\n").split("\t")
                records.append(SpacerRecord(header, header,
                                            seq.encode("ascii"), int(fidx)))
        sources = []
        with open(files[0] + ".sources.tsv") as fh:
            for line in fh:
                sources.append(line.rstrip("\n").split("\t")[1])
        db = build_setdb_from_spacers(
            records, sources,
            reverse_fragments=bool(args.reverse_fragments),
            orf_max_length=args.max_length,
            translation_table=args.translation_table,
            tax_mapping_file=args.tax_mapping_file,
            taxdump_dir=args.ncbi_tax_dump)
    else:
        db = build_setdb_from_fasta(
            files, spacer_mode=bool(args.extractorf_spacer),
            reverse_fragments=bool(args.reverse_fragments),
            orf_min_length=args.min_length, orf_max_length=args.max_length,
            translation_table=args.translation_table,
            tax_mapping_file=args.tax_mapping_file,
            taxdump_dir=args.ncbi_tax_dump,
            shuffle=bool(args.shuffle))
    db.save(out_db)
    try:
        with open(stamp_file, "w") as fh:
            fh.write(stamp_hash)
    except OSError:
        pass
    print(f"createsetdb: {db.n_contigs} contigs, {db.n_orfs} ORFs, "
          f"{db.n_sets} sets in {time.time()-t0:.1f}s -> {out_db}")
    return 0


def cmd_parsespacer(argv):
    p = argparse.ArgumentParser(prog="spacepharer parsespacer")
    p.add_argument("inputs", nargs="+", help="spacer files/dir/tsv + outDB")
    p.add_argument("--file-include", type=str, default=".*")
    p.add_argument("--file-exclude", type=str, default="^$")
    p.add_argument("--compressed", type=int, default=0,
                   help="emit per-entry zstd DBs (DBWriter --compressed)")
    args = p.parse_args(argv)
    if len(args.inputs) < 2:
        p.error("need <files...> <outDB>")
    *inputs, out_db = args.inputs
    files = collect_input_files(inputs, args.file_include, args.file_exclude)
    records, sources = parse_spacers(files)
    os.makedirs(os.path.dirname(out_db) or ".", exist_ok=True)
    with open(out_db + ".spacers.tsv", "w") as fh:
        for i, r in enumerate(records):
            fh.write(f"{i}\t{r.header}\t{r.file_idx}\t"
                     f"{r.seq.decode('ascii')}\n")
    with open(out_db + ".sources.tsv", "w") as fh:
        for i, s in enumerate(sources):
            fh.write(f"{i}\t{s}\n")
    # ALSO emit the reference's MMseqs DB layout (sequence DB + _h
    # header DB + .lookup/.source), so reference-side tooling — incl.
    # its own regression script's `query.index` check — reads our
    # output unchanged
    from .io.mmseqs_compat import (DBTYPE_GENERIC, DBTYPE_NUCL,
                                   write_mmseqs_db)
    write_mmseqs_db(out_db, [r.seq for r in records], DBTYPE_NUCL,
                    compressed=bool(args.compressed))
    write_mmseqs_db(out_db + "_h",
                    [r.header.encode("ascii") for r in records],
                    DBTYPE_GENERIC, compressed=bool(args.compressed))
    with open(out_db + ".lookup", "w") as fh:
        for i, r in enumerate(records):
            fh.write(f"{i}\t{r.header}\t{r.file_idx}\n")
    with open(out_db + ".source", "w") as fh:
        for i, s in enumerate(sources):
            fh.write(f"{i}\t{s}\n")
    print(f"parsespacer: {len(records)} spacers from {len(sources)} files "
          f"-> {out_db}.spacers.tsv")
    return 0


def cmd_predictmatch(argv):
    p = argparse.ArgumentParser(prog="spacepharer predictmatch")
    p.add_argument("querySetDB")
    p.add_argument("targetSetDB")
    p.add_argument("controlSetDB")
    p.add_argument("output")
    p.add_argument("tmpDir")
    _add_predict_flags(p)
    args = p.parse_args(argv)
    from .logging import set_verbosity
    set_verbosity(args.verbosity)
    qdb = SetDB.load(args.querySetDB)
    tdb = SetDB.load(args.targetSetDB)
    cdb = SetDB.load(args.controlSetDB)
    pp = _predict_params(args)
    cache = _make_cache(args.tmpDir, "predictmatch", pp,
                        [args.querySetDB, args.targetSetDB,
                         args.controlSetDB], args.force_restart)
    res = predict_match(qdb, tdb, cdb, pp, cache=cache,
                        dump_stages=args.dump_stages)
    _write_outputs(res, args.output)
    if args.remove_tmp_files:
        import shutil
        shutil.rmtree(args.tmpDir, ignore_errors=True)
    return 0


def cmd_easy_predict(argv):
    p = argparse.ArgumentParser(prog="spacepharer easy-predict")
    p.add_argument("inputs", nargs="+",
                   help="spacer files..., targetSetDB, output.tsv, tmpDir")
    _add_predict_flags(p)
    p.add_argument("--tax-mapping-file", type=str, default=None)
    p.add_argument("--ncbi-tax-dump", type=str, default=None)
    args = p.parse_args(argv)
    if len(args.inputs) < 4:
        p.error("need <spacer files...> <targetSetDB> <output.tsv> <tmpDir>")
    *files, target, output, tmp = args.inputs
    os.makedirs(tmp, exist_ok=True)
    records, sources = parse_spacers(collect_input_files(files))
    qdb = build_setdb_from_spacers(records, sources,
                                   tax_mapping_file=args.tax_mapping_file,
                                   taxdump_dir=args.ncbi_tax_dump)
    tdb = SetDB.load(target)
    control = target + "_rev"
    if not SetDB.exists(control):
        p.error(f"control SetDB {control} not found; run createsetdb with "
                "--reverse-fragments 1")
    cdb = SetDB.load(control)
    from .logging import set_verbosity
    set_verbosity(args.verbosity)
    pp = _predict_params(args)
    cache = _make_cache(tmp, "easy-predict", pp, files + [target],
                        args.force_restart)
    res = predict_match(qdb, tdb, cdb, pp, cache=cache,
                        dump_stages=args.dump_stages)
    _write_outputs(res, output)
    if args.remove_tmp_files:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


def cmd_downloaddb(argv):
    p = argparse.ArgumentParser(prog="spacepharer downloaddb")
    p.add_argument("name", help="catalog name or URL-list tsv")
    p.add_argument("outSetDB")
    p.add_argument("tmpDir")
    p.add_argument("--reverse-setdb", type=int, default=1, choices=(0, 1))
    args = p.parse_args(argv)
    from .pipeline.downloaddb import download_db
    return download_db(args.name, args.outSetDB, args.tmpDir,
                       bool(args.reverse_setdb))


def cmd_multihitdb(argv):
    """multihitdb <fasta...> <outDB> <tmpDir> — generic multihit SetDB
    (lib/mmseqs/src/multihit/MultiHitDb.cpp: createsetdb's genome mode,
    orf-min-length 30)."""
    p = argparse.ArgumentParser(prog="spacepharer multihitdb")
    p.add_argument("inputs", nargs="+", help="FASTA files, outDB, tmpDir")
    p.add_argument("--min-length", type=int, default=30)
    p.add_argument("--max-length", type=int, default=32734)
    p.add_argument("--translation-table",
                   type=_ranged(int, 1, 31, "--translation-table"),
                   default=1)
    args = p.parse_args(argv)
    if len(args.inputs) < 3:
        p.error("need <fasta...> <outDB> <tmpDir>")
    *files, out_db, tmp = args.inputs
    os.makedirs(tmp, exist_ok=True)
    db = build_setdb_from_fasta(
        files, orf_min_length=args.min_length,
        orf_max_length=args.max_length,
        translation_table=args.translation_table)
    db.save(out_db)
    print(f"multihitdb: {db.n_contigs} contigs, {db.n_orfs} ORFs, "
          f"{db.n_sets} sets -> {out_db}")
    return 0


def cmd_multihitsearch(argv):
    """multihitsearch <querySetDB> <targetSetDB> <out.tsv> <tmpDir> —
    search + besthitperset + mergeresultsbyset
    (lib/mmseqs/src/multihit/MultiHitSearch.cpp defaults: s=5.7, e=100,
    simple best hit; its "maxSequences = 1500" line sets the clustering
    --max-sequences member, so the EFFECTIVE --max-seqs is the 300
    default — same quirk as PredictMatch, see PrefilterParams). Chain
    the combinepvalperset expert command for the combined set
    P-values."""
    p = argparse.ArgumentParser(prog="spacepharer multihitsearch")
    p.add_argument("querySetDB")
    p.add_argument("targetSetDB")
    p.add_argument("output")
    p.add_argument("tmpDir")
    p.add_argument("-e", "--evalue", type=float, default=100.0)
    p.add_argument("-s", "--sensitivity",
                   type=_ranged(float, 1.0, 9.5, "-s"), default=5.7)
    p.add_argument("--start-sens", type=float, default=4.0)
    p.add_argument("--sens-steps",
                   type=_ranged(int, 1, 32, "--sens-steps"), default=1,
                   help="iterative search steps (blastp.sh STEPS loop)")
    p.add_argument("--max-seqs",
                   type=_ranged(int, 1, None, "--max-seqs"), default=300)
    p.add_argument("--threads", type=int, default=0)
    p.add_argument("--simple-best-hit", type=int, default=1, choices=(0, 1))
    # the generic MMseqs surface defaults to BLOSUM62 with 11/1 gaps
    # (lib/mmseqs/src/commons/Parameters.cpp scoringMatrixFile /
    # gapOpen defaults, used unchanged by MultiHitSearch.cpp);
    # SpacePHARER's own commands keep the VTML family
    p.add_argument("--sub-mat", type=str, default="blosum62.out")
    p.add_argument("--gap-open", type=int, default=11)
    p.add_argument("--gap-extend", type=int, default=1)
    args = p.parse_args(argv)
    from .io.entries_tsv import write_entries
    from .ops.evalue import gumbel_params
    from .pipeline.predictmatch import search_setdbs
    from .stats.aggregation import best_hit_per_set, merge_results_by_set
    try:
        gumbel_params(args.sub_mat, args.gap_open, args.gap_extend)
    except ValueError as e:
        p.error(f"Invalid argument: {e}")
    qdb = SetDB.load(args.querySetDB)
    tdb = SetDB.load(args.targetSetDB)
    os.makedirs(args.tmpDir, exist_ok=True)
    pp = PredictParams(threads=args.threads, perform_nucl_aln=False,
                       device=requested_device())
    pp.prefilter.sensitivity = args.sensitivity
    pp.prefilter.start_sens = args.start_sens
    pp.prefilter.sens_steps = args.sens_steps
    pp.prefilter.max_seqs = args.max_seqs
    pp.prefilter.ungapped_matrix = args.sub_mat
    pp.align.matrix = args.sub_mat
    pp.align.gap_open = args.gap_open
    pp.align.gap_extend = args.gap_extend
    pp.align.evalue = args.evalue
    result = search_setdbs(qdb, tdb, pp)
    aggregate = {k: best_hit_per_set(rows, tdb.orf_to_set, tdb.set_size,
                                     bool(args.simple_best_hit))
                 for k, rows in result.items()}
    set_to_members = {}
    for okey in range(qdb.n_orfs):
        set_to_members.setdefault(int(qdb.orf_to_set[okey]), []).append(okey)
    merged = merge_results_by_set(aggregate,
                                  dict(sorted(set_to_members.items())))
    write_entries(merged, args.output)
    n = sum(len(v) for v in merged.values())
    print(f"multihitsearch: {n} aggregated hits over "
          f"{len(merged)} query sets -> {args.output}")
    return 0


def cmd_createindex(argv):
    """createindex <setDB> <tmpDir> — persist the prefilter k-mer index
    inside the SetDB, keyed by the prefilter parameters (the MMseqs
    createindex analog). Searches then mmap it instead of rebuilding."""
    p = argparse.ArgumentParser(prog="spacepharer createindex")
    p.add_argument("setDB")
    p.add_argument("tmpDir")
    p.add_argument("-s", "--sensitivity",
                   type=_ranged(float, 1.0, 9.5, "-s"), default=5.7)
    p.add_argument("-k", "--kmer-size",
                   type=_ranged(int, 4, 8, "-k"), default=6)
    p.add_argument("--spaced-kmer-pattern", type=str, default="11011101")
    p.add_argument("--mask", type=int, default=1, choices=(0, 1))
    args = p.parse_args(argv)
    from .ops.prefilter import (PrefilterParams, build_target_index,
                                save_target_index)
    db = SetDB.load(args.setDB)
    os.makedirs(args.tmpDir, exist_ok=True)
    pp = PrefilterParams(
        kmer_size=args.kmer_size, spaced_pattern=args.spaced_kmer_pattern,
        sensitivity=args.sensitivity, mask=bool(args.mask))
    t_flat, t_off = db.orf_aa_encoded()
    t_aa = [t_flat[t_off[i]:t_off[i + 1]] for i in range(db.n_orfs)]
    t0 = time.time()
    index = build_target_index(t_aa, pp, packed=(t_flat, t_off))
    d = save_target_index(index, args.setDB, pp)
    print(f"createindex: {index.n_postings} postings in "
          f"{time.time() - t0:.1f}s -> {d}")
    return 0


COMMANDS = {
    "easy-predict": cmd_easy_predict,
    "createsetdb": cmd_createsetdb,
    "predictmatch": cmd_predictmatch,
    "parsespacer": cmd_parsespacer,
    "downloaddb": cmd_downloaddb,
    "multihitdb": cmd_multihitdb,
    "multihitsearch": cmd_multihitsearch,
    "createindex": cmd_createindex,
}

# expert modules (src/spacepharer.cpp:61-135); registered lazily so the
# main commands don't pay their imports
from .cli_expert import EXPERT_COMMANDS  # noqa: E402

COMMANDS.update(EXPERT_COMMANDS)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("Commands:", ", ".join(COMMANDS))
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"Unknown command {cmd!r}. Commands: {', '.join(COMMANDS)}",
              file=sys.stderr)
        return 1
    try:
        return COMMANDS[cmd](argv[1:])
    finally:
        # the command's SetDBs end with it: free their device copies
        from .ops import resident
        resident.release()


if __name__ == "__main__":
    sys.exit(main())
