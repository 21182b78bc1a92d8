"""The card's busy time per set: the union of the window's kernel, copy
and memset intervals (the device trace), over the sets of every call
whose two searches returned, failed or not: the card's work for them is
done (ROADMAP C4 fails in the FDR step, after both searches); a call
that fails sooner adds its card time and no set."""


def read(record):
    sent = sum(c["sets"] for c in record["calls"] if c["searched"])
    if not sent or "busy_us" not in record:
        return None
    return record["busy_us"] * 1e-3 / sent
