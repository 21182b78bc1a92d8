"""One generator for every traffic mix: batches of CRISPR spacer sets.

A mix file (portbench/traffic/<name>.json) gives

    sets_per_call     spacer sets in one predictmatch call
    warm_sets         spacer sets in the set-up's warm call
    set_sizes         spacers a set: the sets of a batch take these
                      sizes in turn
    spacer_nt         {length: count}: the spacers of a batch take these
                      lengths in proportion
    hit_fraction      share of the spacers that are protospacers
    hit_substitution  [lowest, highest] substitution rate of a protospacer

Batch `call` of a run is drawn from (seed, call) alone. Every batch of a
size holds the same multiset of set sizes, of spacer lengths and the same
number of protospacers, so seeds change which sequences a call holds and
in what order, not how much work it is. A protospacer is a substring of a
random catalog genome, on a random strand, with each base changed to
another at a rate drawn from `hit_substitution`; the other spacers are
random ACGT.
"""
from dataclasses import dataclass, field

import numpy as np

from .catalog import BASES, _CODE

_COMP = np.frombuffer(b"TGCA", dtype=np.uint8)   # complement of ACGT codes
# the call index of the warm-up batch: a draw no window call makes
WARM_CALL = 1 << 31


@dataclass
class Batch:
    call: int
    set_names: list          # one name per set
    spacers: list            # (header, set index, uint8 ASCII sequence)
    hit_sets: list           # indices of the sets that carry protospacers
    hit_spacers: list = field(default_factory=list)   # the protospacers


def _rng(seed, call, stream):
    return np.random.default_rng([int(seed) % (1 << 64), call, stream])


def make_batch(mix: dict, seed: int, call: int, genomes,
               n_sets: int = None) -> Batch:
    """Batch `call` of the mix: `n_sets` sets (the mix's sets_per_call
    when None)."""
    n_sets = int(mix["sets_per_call"] if n_sets is None else n_sets)
    rng = _rng(seed, call, 0)
    sizes = rng.permutation(np.resize(np.asarray(mix["set_sizes"],
                                                 dtype=np.int64), n_sets))
    total = int(sizes.sum())
    pool = np.repeat([int(k) for k in mix["spacer_nt"]],
                     [int(v) for v in mix["spacer_nt"].values()])
    lengths = rng.permutation(np.resize(np.sort(pool), total))
    n_hit = int(round(total * float(mix["hit_fraction"])))
    is_hit = np.zeros(total, dtype=bool)
    is_hit[rng.choice(total, n_hit, replace=False)] = True
    set_of = np.repeat(np.arange(n_sets), sizes)
    sub_lo, sub_hi = (float(x) for x in mix["hit_substitution"])
    spacers = []
    for i in range(total):
        si, n = int(set_of[i]), int(lengths[i])
        pi = i - int(np.searchsorted(set_of, si))
        if is_hit[i]:
            g = int(rng.integers(genomes.n))
            genome = genomes.seq(g)
            p = int(rng.integers(0, len(genome) - n + 1))
            s = genome[p:p + n]
            if rng.random() < 0.5:
                s = _COMP[_CODE[s[::-1]]]
            rate = rng.uniform(sub_lo, sub_hi)
            code = _CODE[s]
            hit = rng.random(n) < rate
            shift = rng.integers(1, 4, size=int(hit.sum()))
            s = s.copy()
            s[hit] = BASES[(code[hit] + shift) % 4]
        else:
            s = BASES[rng.integers(0, 4, n)]
        spacers.append((f"set{si:06d}_1_100_{pi + 1}_spacer_{pi * 61}_{n}",
                        si, np.ascontiguousarray(s, dtype=np.uint8)))
    hit_sets = sorted({int(s) for s in set_of[is_hit]})
    return Batch(call, [f"set{si:06d}.fas" for si in range(n_sets)],
                 spacers, hit_sets, [int(i) for i in np.flatnonzero(is_hit)])


def sample_sets(batch: Batch, seed: int, n_hit: int, n_other: int) -> list:
    """The sets of a batch that the output check reads: n_hit of the sets
    with protospacers and n_other of the rest, drawn from (seed, call)."""
    rng = _rng(seed, batch.call, 1)
    hits = list(batch.hit_sets)
    others = sorted(set(range(len(batch.set_names))) - set(hits))
    pick = []
    if hits:
        pick += [hits[i] for i in rng.choice(len(hits), min(n_hit, len(hits)),
                                             replace=False)]
    if others:
        pick += [others[i] for i in rng.choice(len(others),
                                               min(n_other, len(others)),
                                               replace=False)]
    return sorted(pick)
