"""Cells as data: the generator, and files added to the tree becoming
cells and metrics without an edit."""
import json
import os

import numpy as np

from portbench import catalog, cells, traffic

MIX = dict(sets_per_call=12, warm_sets=3, set_sizes=[2, 3, 5],
           spacer_nt={"30": 3, "32": 5, "36": 2}, hit_fraction=0.1,
           hit_substitution=[0.0, 0.05])
CATALOG = dict(genomes=6, mean_nt=8000, length_log_sd=0.6,
               length_nt_range=[3000, 20000], data_seed=3)


def genomes(n=6):
    return catalog.Genomes(dict(CATALOG, genomes=n))


def test_genomes_are_distinct_and_gene_dense():
    g = genomes()
    seqs = [g.seq(k) for k in range(g.n)]
    assert all(len(s) == g.length(k) for k, s in enumerate(seqs))
    assert all(3000 <= len(s) <= 20000 for s in seqs)
    assert np.array_equal(g.seq(2), seqs[2])
    assert len({g.name(k) for k in range(g.n)}) == g.n
    # distinct genomes share only chance 12-mers
    kmers = [{s[i:i + 12].tobytes() for i in range(len(s) - 11)}
             for s in seqs]
    assert max(len(kmers[a] & kmers[b]) for a in range(g.n)
               for b in range(a)) < 20
    # most of a genome lies in long ORFs, as in a phage
    from portbench.reference import seqs as ref_seqs
    for s in seqs[:2]:
        long = [abs(t - f) + 1 for f, t in ref_seqs.genome_orfs(s, 100)]
        assert sum(long) > 0.6 * len(s)


def test_batch_is_a_function_of_seed_and_call():
    g = genomes()
    a = traffic.make_batch(MIX, 2 ** 33 + 5, 0, g)
    b = traffic.make_batch(MIX, 2 ** 33 + 5, 0, g)
    c = traffic.make_batch(MIX, 2 ** 33 + 6, 0, g)
    d = traffic.make_batch(MIX, 2 ** 33 + 5, 1, g)
    seqs = [[s.tobytes() for _, _, s in x.spacers] for x in (a, b, c, d)]
    assert seqs[0] == seqs[1]
    assert seqs[0] != seqs[2] and seqs[0] != seqs[3]
    assert a.hit_sets == b.hit_sets


def _hamming_to_catalog(s, g):
    best = len(s)
    for k in range(g.n):
        genome = g.seq(k)
        for strand in (genome, catalog.BASES[
                (3 - catalog._CODE[genome[::-1]]) % 4]):
            win = np.lib.stride_tricks.sliding_window_view(strand, len(s))
            best = min(best, int((win != s).sum(axis=1).min()))
    return best


def test_batch_sizes_and_protospacers():
    g = genomes()
    for seed in (0, 7, 2 ** 31 + 3):
        b = traffic.make_batch(MIX, seed, 0, g)
        assert len(b.set_names) == 12
        assert len(b.spacers) == 40
        sizes = np.bincount([si for _, si, _ in b.spacers])
        assert sorted(sizes) == sorted([2, 3, 5] * 4)
        lengths = sorted(len(s) for _, _, s in b.spacers)
        assert lengths == [30] * 12 + [32] * 20 + [36] * 8
        assert len(b.hit_spacers) == 4
        assert b.hit_sets == sorted({b.spacers[i][1] for i in b.hit_spacers})
        hits = [b.spacers[i][2] for i in b.hit_spacers]
        # substitutions drawn at up to 5 % stay far below 15 %, which a
        # random spacer is far above
        assert all(_hamming_to_catalog(s, g) <= int(0.15 * len(s))
                   for s in hits[:3])
        other = [s for i, (_, _, s) in enumerate(b.spacers)
                 if i not in b.hit_spacers]
        assert _hamming_to_catalog(other[0], g) > int(0.15 * len(other[0]))


def test_sampled_sets_take_hits_first():
    b = traffic.make_batch(MIX, 11, 0, genomes())
    picked = traffic.sample_sets(b, 11, 2, 2)
    assert len(picked) == 4
    assert len(set(picked) & set(b.hit_sets)) == min(2, len(b.hit_sets))
    assert picked == traffic.sample_sets(b, 11, 2, 2)


def test_added_files_become_a_cell_and_a_metric(tmp_path):
    here = tmp_path / "portbench"
    for d in ("configs", "traffic", "metrics", "end_to_end"):
        (here / d).mkdir(parents=True)
    with open(os.path.join(cells.HERE, "configs",
                           "genbank_phage.dense.json")) as fh:
        (here / "configs" / "genbank_phage.dense.json").write_text(fh.read())
    mix = dict(MIX, sets_per_call=7)
    (here / "traffic" / "new_mix.json").write_text(json.dumps(mix))
    (here / "metrics" / "calls_seen.py").write_text(
        "def read(record):\n    return len(record['calls']) or None\n")
    (here / "end_to_end" / "calls_per_s.py").write_text(
        "def read(record):\n    return len(record['calls']) / "
        "record['window_s']\n")
    bench = cells.benchmark()
    bench["workloads"].append({"name": "dense.new_mix",
                               "config": "genbank_phage.dense",
                               "traffic": "new_mix", "chips": 1,
                               "why": "added as data"})
    bench["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock"})
    bench["per_layer"].append({"name": "calls_seen", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "harness", "moves": "sets_per_s"})
    spec = cells.resolve("dense.new_mix", bench, str(here))
    assert spec["traffic"]["sets_per_call"] == 7
    assert "calls_seen" in [m["name"] for m in spec["per_layer"]]
    assert "calls_per_s" in [m["name"] for m in spec["end_to_end"]]
    rate = cells.metric_reader("calls_per_s", str(here), "end_to_end")
    assert rate({"calls": [1, 2], "window_s": 4.0}) == 0.5
    b = traffic.make_batch(spec["traffic"], 1, 0, genomes())
    assert len(b.set_names) == 7
    read = cells.metric_reader("calls_seen", str(here))
    assert read({"calls": [1, 2]}) == 2 and read({"calls": []}) is None


def test_benchmark_names_and_files():
    bench = cells.benchmark()
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert n[0].isalnum() or n[0] == "_"
        assert all(ch.isalnum() or ch in "_.-" for ch in n) and len(n) <= 64
    for w in bench["workloads"]:
        spec = cells.resolve(w["name"], bench)
        assert spec["config"]["name"] == w["config"]
    for m in bench["per_layer"]:
        assert callable(cells.metric_reader(m["name"]))
    for m in bench["end_to_end"]:
        assert callable(cells.metric_reader(m["name"], kind="end_to_end"))
