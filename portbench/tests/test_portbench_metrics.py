"""The yardstick's arithmetic against hand counts, and the device-trace
reduction on made-up intervals."""
import numpy as np
import pytest

from portbench import cells, trace, traffic
from portbench.reference import seqs

H100 = "NVIDIA H100 80GB HBM3"


def test_rows_that_can_match_by_hand():
    # (GCT)x10: every frame of both strands is a stop-free run of 9 or 10
    # codons (GCT.., CTG.., TGC..; AGC.., GCA.., CAG..), and an ORF of L
    # residues seeks matches from L - 8 k-mer rows: 2+1+1+2+1+1
    s = np.frombuffer(b"GCT" * 10, dtype=np.uint8)
    orfs = seqs.spacer_orfs(s)
    assert sorted(len(aa) for _, _, aa in orfs) == [9, 9, 9, 9, 10, 10]
    batch = traffic.Batch(0, ["a"], [("a", 0, s)], [])
    assert seqs.rows_that_can_match(batch) == 8


def test_b2_share_by_hand():
    s = np.frombuffer(b"GCT" * 10, dtype=np.uint8)
    batch = traffic.Batch(0, ["a"], [("a", 0, s)], [])
    rec = {"device_kind": H100, "kernels": {"counts_kernel(int)": 2000.0},
           "calls": [{"batch": batch, "searches": [("fwd", 10 ** 9),
                                                     ("control", 10 ** 9)]}]}
    from portbench.metrics import b2_counts_roofline
    # 8 rows x 2e9 positions x 256 operations / 1979e12 per s / 2 ms
    want = 100 * (8 * 2e9 * 256 / 1979e12) / 2e-3
    assert b2_counts_roofline.read(rec) == pytest.approx(want)


def test_b1_share_by_hand():
    from portbench.metrics import b1_pairs_roofline
    rec = {"device_kind": H100, "pair_cells": 10 ** 9,
           "kernels": {"sw_pairs_kernel": 800.0, "pair_keys_kernel": 200.0,
                       "other": 5.0}}
    want = 100 * (6e9 / (132 * 64 * 1.98e9)) / 1e-3
    assert b1_pairs_roofline.read(rec) == pytest.approx(want)
    assert b1_pairs_roofline.read(dict(rec, kernels={})) is None
    assert b1_pairs_roofline.read(dict(rec, device_kind="cpu")) is None


def test_end_to_end_reads():
    # a call that failed after both searches counts its sets for the
    # card, one that failed sooner does not; neither counts for the rate
    calls = [{"sets": 500, "ok": True, "searched": True},
             {"sets": 500, "ok": False, "searched": True},
             {"sets": 500, "ok": False, "searched": False}]
    rec = {"sets": 500, "window_s": 50.0, "setup_s": 30.0, "busy_us": 4e6,
           "calls": calls}
    card = cells.metric_reader("card_ms_per_set", kind="end_to_end")
    assert card(rec) == 4.0
    assert cells.metric_reader("setup_s", kind="end_to_end")(rec) == 30.0
    assert card(dict(rec, calls=[])) is None
    rate = cells.metric_reader("sets_per_s.host_paced")
    assert rate(rec) == 10.0 and rate(dict(rec, sets=0)) == 0.0


def test_union_and_idle_gaps():
    merged = trace.union([(0, 10), (5, 20), (30, 40), (40, 45), (60, 61)])
    assert merged == [[0, 20], [30, 45], [60, 61]]
    spans = [("predict_match", 0, 100), ("report", 46, 59),
             ("search", 0, 45)]
    gaps = trace.idle_gaps(merged, spans, 0, 100, top=2)
    assert [g[0] for g in gaps] == ["predict_match", "report"]
    assert [g[1] for g in gaps] == pytest.approx([39e-6, 15e-6])
