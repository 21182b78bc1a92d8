"""The per-layer metrics that read the port's own spans and counters
(portbench/stages.py) on made-up call records: each call's stages
averaged over the completed calls, and nothing from a port that has not
got them."""
import pytest

from portbench import cells

# metric -> (the stages it sums, its scale)
METRICS = {
    "target_orfs_s.host_paced": (("target_orfs",), 1.0),
    "dense_pass_s.host_paced": (("dense_pass",), 1.0),
    "dense_finalize_s.host_paced": (("dense_finalize",), 1.0),
    "scoring_s.host_paced": (("host_align", "card_scoring"), 1.0),
    "nucl_merge_s.host_paced": (("nucl_merge",), 1.0),
    "aggregation_s.host_paced": (("aggregation",), 1.0),
    "search_self_s.host_paced": (("search_setdbs.self",), 1.0),
    "upload_mb.host_paced": (("h2d_bytes",), 1e-6),
}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_stage_metric_reads_its_stages_per_call(name):
    keys, scale = METRICS[name]
    read = cells.metric_reader(name)

    def call(ok, value):
        return {"ok": ok, "stages": dict.fromkeys(keys, value)}
    calls = [call(True, 2.0), call(True, 4.0), call(False, 100.0)]
    assert read({"calls": calls}) == pytest.approx(3.0 * len(keys) * scale)
    # every call failed: all of them count
    assert read({"calls": calls[2:]}) == pytest.approx(
        100.0 * len(keys) * scale)
    # the parent's port, without the span or counter: nothing
    assert read({"calls": [{"ok": True, "stages": {"search": 1.0}}]}) is None
