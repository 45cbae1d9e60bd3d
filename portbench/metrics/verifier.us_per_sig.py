"""Microseconds of the verifier's calls a signature on the card: the
window's delta of `verifier.e2e_s`'s sum (each call's wall, calls in
flight together each counted) over the delta of `verifier.sigs`."""


def read(r):
    h = r.window["histograms"].get("verifier.e2e_s")
    sigs = r.window["counters"].get("verifier.sigs", 0)
    return 1e6 * h["sum"] / sigs if h and sigs > 0 else None
