"""Spacer sets predicted per second, the user's rate: the sets of the
calls completed in the window over the whole window (a call that fails
spends its time and completes no set). Host-paced: the card is idle most
of the window, and the calls that fail (ROADMAP C4, the FDR walk) make
it swing from seed to seed, so it is read here and not bounded."""


def read(record):
    return record["sets"] / record["window_s"]
