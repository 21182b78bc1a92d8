"""The configuration's catalog: distinct synthetic phage genomes, built
once per checkout into the port's target and control SetDBs.

Each genome is made from (data_seed, g) alone: a length drawn from the
catalog's length distribution, then genes and gaps drawn from the gene
model of one of three complete phages of the GenBank phage catalog
(portbench/data/golden_phages.fna.gz: P2, Bcep1, A118): their codon
usage, gene lengths, coding density and base composition. No two genomes
share more than chance k-mers (related phages of a real catalog share
more). The SetDBs are built by the port's own createsetdb code
(build_setdb_from_fasta), as a user builds a catalog.
"""
import gzip
import hashlib
import json
import os
import shutil
import time
from functools import lru_cache

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "data", "golden_phages.fna.gz")
CACHE = os.path.join(HERE, ".cache")
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i
    _CODE[_b + 32] = _i


def golden_genomes(path=GOLDEN):
    """[(accession, header, uint8 ASCII sequence)] of the golden phages."""
    out, header, parts = [], None, []
    with gzip.open(path, "rb") as fh:
        for line in fh:
            if line.startswith(b">"):
                if header is not None:
                    out.append((header.split()[0], header,
                                np.frombuffer(b"".join(parts), np.uint8)))
                header, parts = line[1:].strip().decode(), []
            else:
                parts.append(line.strip())
    out.append((header.split()[0], header,
                np.frombuffer(b"".join(parts), np.uint8)))
    return out


# codons as ACGT digits (A0 C1 G2 T3), first base most significant
_CODONS = np.array([[a, b, c] for a in range(4) for b in range(4)
                    for c in range(4)], dtype=np.uint8)
_STOPS = np.array([int("".join(str("ACGT".index(x)) for x in c), 4)
                   for c in ("TAA", "TAG", "TGA")])
_ATG = int("032", 4)
_SENSE = np.setdiff1d(np.arange(64), _STOPS)
MIN_GENE_CODONS = 100        # ORFs of the golden phages read as genes


class GeneModel:
    """What a synthetic genome takes from one golden phage: the codon
    usage of its genes (every ATG-to-stop ORF of at least
    MIN_GENE_CODONS codons, on either strand), their lengths, the share
    of the genome they cover and the base composition of the rest."""

    def __init__(self, seq: np.ndarray):
        code = _CODE[seq]
        lengths, starts, ends, usage, stops = [], [], [], np.zeros(64), \
            np.zeros(64)
        L = len(code)
        for minus in (False, True):
            strand = (3 - code[::-1]) if minus else code
            for f in range(3):
                n = (L - f) // 3
                c = strand[f:f + 3 * n].reshape(n, 3).astype(np.int64)
                idx = c[:, 0] * 16 + c[:, 1] * 4 + c[:, 2]
                stop_at = np.flatnonzero(np.isin(idx, _STOPS))
                prev = -1
                for s in stop_at:
                    atg = np.flatnonzero(idx[prev + 1:s] == _ATG)
                    if len(atg) and s - (prev + 1 + atg[0]) >= \
                            MIN_GENE_CODONS:
                        a = prev + 1 + atg[0]
                        lengths.append(s - a)      # ATG .. before stop
                        np.add.at(usage, idx[a + 1:s], 1)
                        stops[idx[s]] += 1
                        p0, p1 = f + 3 * a, f + 3 * s + 2
                        if minus:
                            p0, p1 = L - 1 - p1, L - 1 - p0
                        starts.append(p0)
                        ends.append(p1 + 1)
                    prev = s
        covered = np.zeros(L + 1, dtype=np.int64)
        np.add.at(covered, starts, 1)
        np.add.at(covered, ends, -1)
        self.coverage = float((np.cumsum(covered)[:L] > 0).mean())
        self.gene_codons = np.array(lengths, dtype=np.int64)
        self.usage = usage[_SENSE] / usage[_SENSE].sum()
        self.stop_usage = stops[_STOPS] / stops[_STOPS].sum()
        counts = np.bincount(code[code < 4], minlength=4)
        self.base_p = counts / counts.sum()
        gene_nt = 3 * (self.gene_codons.mean() + 1)
        self.mean_gap = gene_nt * (1.0 / self.coverage - 1.0)


@lru_cache(maxsize=None)
def gene_models(path=GOLDEN):
    return tuple(GeneModel(s) for _, _, s in golden_genomes(path))


def synthetic_genome(length: int, model: GeneModel, rng) -> np.ndarray:
    """An ACGT genome of `length` bases: genes drawn from the model's
    gene lengths and codon usage (ATG, sense codons, a stop), each on a
    strand drawn at even odds, with gaps of random bases between them
    (lengths uniform on 0 .. twice the model's mean gap)."""
    unit = 3 * (model.gene_codons.mean() + 1) + model.mean_gap
    n = int(length / unit * 1.5) + 4
    while True:                 # draw genes until they cover the length
        codons = rng.choice(model.gene_codons, n) + 1      # with the stop
        gaps = rng.integers(0, int(2 * model.mean_gap) + 1, n)
        minus = rng.random(n) < 0.5
        total = np.cumsum(gaps + 3 * codons)
        if total[-1] >= length:
            break
        n *= 2
    n = int(np.searchsorted(total, length)) + 1
    codons, gaps, minus = codons[:n], gaps[:n], minus[:n]
    c_end = np.cumsum(codons)
    c_start = c_end - codons
    idx = _SENSE[rng.choice(len(_SENSE), int(c_end[-1]), p=model.usage)]
    idx[c_start] = _ATG
    idx[c_end - 1] = _STOPS[rng.choice(3, n, p=model.stop_usage)]
    genes = _CODONS[idx].reshape(-1)                       # ACGT digits
    gene_of = np.repeat(np.arange(n), 3 * codons)
    pos = np.arange(len(genes))
    g0 = np.repeat(3 * c_start, 3 * codons)
    g1 = np.repeat(3 * c_end, 3 * codons)
    flip = minus[gene_of]
    genes = np.where(flip, 3 - genes[np.where(flip, g0 + g1 - 1 - pos, pos)],
                     genes)
    out_start = np.cumsum(gaps + 3 * codons) - 3 * codons  # gene starts
    out = rng.choice(4, int(out_start[-1] + 3 * codons[-1]),
                     p=model.base_p).astype(np.uint8)
    out[out_start[gene_of] + pos - g0] = genes
    return BASES[out[:length]]


class Genomes:
    """The catalog's genomes, made on demand from the catalog settings:
    genome g from (data_seed, g) alone, so that any genome can be made
    again without the others (the traffic's protospacers and the
    reference read them so). Lengths are log-normal with the catalog's
    mean and log spread, cut to its range; genome g follows golden phage
    g % 3's gene model."""

    def __init__(self, catalog: dict, models=None, stored=None):
        self.models = models or gene_models()
        # the build's flat copy of every genome, read in place of making
        # a genome again where the catalog is built
        self.flat = self.offsets = None
        if stored is not None:
            self.flat = np.load(os.path.join(stored, "seq.npy"),
                                mmap_mode="r")
            self.offsets = np.load(os.path.join(stored, "offsets.npy"))
        self.n = int(catalog["genomes"])
        self.data_seed = int(catalog["data_seed"])
        self.mean_nt = float(catalog["mean_nt"])
        self.sigma = float(catalog["length_log_sd"])
        self.lo, self.hi = (int(x) for x in catalog["length_nt_range"])

    def _rng(self, g):
        return np.random.default_rng([self.data_seed, g])

    def name(self, g):
        return f"synphage_cat{g:05d}"

    def _length(self, rng):
        mu = np.log(self.mean_nt) - self.sigma ** 2 / 2
        return int(min(max(rng.lognormal(mu, self.sigma), self.lo), self.hi))

    def length(self, g):
        return self._length(self._rng(g))

    def seq(self, g):
        if self.flat is not None:
            return np.asarray(self.flat[self.offsets[g]:self.offsets[g + 1]])
        rng = self._rng(g)
        length = self._length(rng)
        return synthetic_genome(length, self.models[g % len(self.models)],
                                rng)


def catalog_key(catalog: dict) -> str:
    """The cache name of a catalog: its settings, the golden phages and
    this generator's source."""
    digest = hashlib.sha256()
    for path in (GOLDEN, os.path.abspath(__file__)):
        with open(path, "rb") as fh:
            digest.update(fh.read())
    digest.update(json.dumps(catalog, sort_keys=True).encode())
    return f"catalog-{digest.hexdigest()[:16]}"


def _write_fasta(path, name, seq):
    with gzip.open(path, "wb", compresslevel=1) as fh:
        fh.write(b">" + name.encode() + b" catalog genome\n" + seq.tobytes()
                 + b"\n")


def _tree_bytes(path):
    total = 0
    for d, _, files in os.walk(path):
        for f in files:
            total += os.path.getsize(os.path.join(d, f))
    return total


def _io_written():
    try:
        with open("/proc/self/io") as fh:
            for line in fh:
                if line.startswith("write_bytes:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None


def ensure(catalog: dict, threads: int, log, cache=CACHE) -> dict:
    """{targets, control, genomes, reference, built, stats}: the SetDB
    directories of the catalog, the build's flat copy of its genomes and
    the reference's own table of their ORFs, built first if this
    checkout has none. The build goes to a fixed scratch name and is
    renamed into place when whole, so a run cut off mid-build leaves
    nothing that a later run would take."""
    from spacepharer_tpu_torch.io.setdb import build_setdb_from_fasta
    from .reference import seqs as ref_seqs
    key = catalog_key(catalog)
    final = os.path.join(cache, key)
    paths = dict(targets=os.path.join(final, "targets"),
                 control=os.path.join(final, "targets_rev"),
                 genomes=os.path.join(final, "genomes"),
                 reference=os.path.join(final, "reference_orfs.npy"))
    done = os.path.join(final, "catalog.json")
    if os.path.exists(done):
        with open(done) as fh:
            return dict(paths, built=False, stats=json.load(fh))
    work = final + ".building"
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "fasta"))
    t0 = time.perf_counter()
    io0 = _io_written()
    genomes = Genomes(catalog)
    from concurrent.futures import ThreadPoolExecutor

    def one(g):
        path = os.path.join(work, "fasta", f"g{g:05d}.fna.gz")
        seq = genomes.seq(g)
        _write_fasta(path, genomes.name(g), seq)
        return path, seq
    with ThreadPoolExecutor(max_workers=max(threads, 1)) as ex:
        files, seqs = zip(*ex.map(one, range(genomes.n)))
    files = list(files)
    fasta_bytes = _tree_bytes(os.path.join(work, "fasta"))
    os.makedirs(os.path.join(work, "genomes"))
    np.save(os.path.join(work, "genomes", "seq.npy"), np.concatenate(seqs))
    np.save(os.path.join(work, "genomes", "offsets.npy"),
            np.concatenate(([0], np.cumsum([len(x) for x in seqs]))))
    t_ref = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(threads, 1)) as ex:
        np.save(paths["reference"].replace(final, work),
                ref_seqs.orf_table(list(ex.map(ref_seqs.genome_orfs, seqs))))
    del seqs
    t1 = time.perf_counter()
    tdb = build_setdb_from_fasta(files)
    tdb.save(os.path.join(work, "targets"))
    n_orfs, residues = tdb.n_orfs, int(tdb.orf_aa_offsets[-1])
    del tdb
    cdb = build_setdb_from_fasta(files, reverse_fragments=True)
    cdb.save(os.path.join(work, "targets_rev"))
    del cdb
    shutil.rmtree(os.path.join(work, "fasta"))
    io1 = _io_written()
    stats = dict(genomes=genomes.n, target_orfs=n_orfs,
                 target_residues=residues,
                 nucleotides=sum(genomes.length(g)
                                 for g in range(genomes.n)),
                 fasta_s=t_ref - t0, reference_orfs_s=t1 - t_ref,
                 setdb_s=time.perf_counter() - t1,
                 fasta_bytes=fasta_bytes,
                 genome_bytes=_tree_bytes(os.path.join(work, "genomes")),
                 setdb_bytes=_tree_bytes(work),
                 process_write_bytes=(None if io0 is None or io1 is None
                                      else io1 - io0))
    with open(os.path.join(work, "catalog.json"), "w") as fh:
        json.dump(stats, fh)
    os.replace(work, final)
    log(f"catalog built in "
        f"{stats['fasta_s'] + stats['reference_orfs_s'] + stats['setdb_s']:.1f}"
        f" s: "
        f"{json.dumps(stats)}")
    return dict(paths, built=True, stats=stats)
