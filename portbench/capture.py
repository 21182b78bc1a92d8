"""What the check reads of the window's calls, taken where the port makes
it: wrappers set by name on the functions that predict_match calls.

For each call the harness names the query ORF keys of the sampled sets;
the wrappers keep, for those keys only, the dense prefilter's candidate
lists, the protein rows before the nucleotide merge and the final rows,
of the forward and of the control search. They also count, for every key,
the true DP cells of the candidate pairs (query length x target length),
which the GPU scoring engine's kernels score.
"""
import numpy as np

from .trace import Wrappers

PD = "spacepharer_tpu_torch.ops.prefilter_dense"
PM = "spacepharer_tpu_torch.pipeline.predictmatch"


class Capture:
    def __init__(self, wrappers: Wrappers, target_db):
        self.target_db = target_db
        self.keys = set()         # sampled query ORF keys of the call
        self.side = None          # "fwd" or "control" during a search
        self.cand = {}            # (side, key) -> (targets, scores, diags)
        self.prot = {}            # (side, key) -> protein rows
        self.rows = {}            # (side, key) -> final rows
        self.pair_cells = 0       # true DP cells of every candidate pair
        self.searches = []        # (side, masked target residues)
        self.searched = 0         # searches that returned, over the run
        wrappers.wrap(PM, "search_setdbs", self._search)
        wrappers.wrap(PD, "device_prefilter_arrays", self._prefilter)
        wrappers.wrap(PM, "_nucl_merge", self._nucl)

    def start_call(self, keys):
        self.keys = set(int(k) for k in keys)
        self.cand, self.prot, self.rows = {}, {}, {}

    def _search(self, orig):
        def inner(query_db, target_db, params, keys=None):
            self.side = "fwd" if target_db is self.target_db else "control"
            try:
                out = orig(query_db, target_db, params, keys=keys)
            finally:
                side, self.side = self.side, None
            self.searched += 1
            for k in self.keys:
                self.rows[(side, k)] = [list(r) for r in out.get(k, [])]
            return out
        return inner

    def _prefilter(self, orig):
        def inner(q_all, keys, bias80_all, t_flat, t_starts, *a, **kw):
            out = orig(q_all, keys, bias80_all, t_flat, t_starts, *a, **kw)
            t, s, d, off = out
            qlen = np.array([len(q_all[k]) for k in keys], dtype=np.int64)
            tlen = np.diff(np.asarray(t_starts, dtype=np.int64))
            self.pair_cells += int(np.dot(np.repeat(qlen, np.diff(off)),
                                          tlen[t]))
            self.searches.append((self.side, int(len(t_flat))))
            for i, k in enumerate(keys):
                if int(k) in self.keys:
                    lo, hi = int(off[i]), int(off[i + 1])
                    self.cand[(self.side, int(k))] = (
                        np.array(t[lo:hi]), np.array(s[lo:hi]),
                        np.array(d[lo:hi]))
            return out
        return inner

    def _nucl(self, orig):
        def inner(prot, query_db, target_db, params):
            for k in self.keys:
                self.prot[(self.side, k)] = [list(r) for r in prot.get(k, [])]
            return orig(prot, query_db, target_db, params)
        return inner
