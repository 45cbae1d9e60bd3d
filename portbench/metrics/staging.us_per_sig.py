"""Microseconds of host staging (`native/staging.cpp`, one call a chunk)
a signature on the card: the window's delta of `verifier.stage_s`'s sum
over the delta of `verifier.sigs`."""


def read(r):
    h = r.window["histograms"].get("verifier.stage_s")
    sigs = r.window["counters"].get("verifier.sigs", 0)
    return 1e6 * h["sum"] / sigs if h and sigs > 0 else None
