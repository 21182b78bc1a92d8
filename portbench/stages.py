"""What the per-layer metrics of the port's own spans and counters read:
each call's increase of spacepharer_tpu_torch.logging.timings(), which
the harness keeps as the call's `stages`."""


def per_call(record, *keys, scale=1.0):
    """The sum of `keys` in a call's stages, times `scale`, averaged over
    the completed calls, or over every call where none completed; None
    where no call holds any of the keys (a port without those spans or
    counters)."""
    calls = [c for c in record["calls"] if c["ok"]] or record["calls"]
    if not any(k in c["stages"] for c in calls for k in keys):
        return None
    total = sum(c["stages"].get(k, 0.0) for c in calls for k in keys)
    return scale * total / len(calls)
