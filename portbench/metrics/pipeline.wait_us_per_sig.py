"""Microseconds a signature on the card waits between the dispatch
pipeline's threads: the window's delta of `pipeline.wait_s`'s sum (each
chunk's wait for the upload worker after its stage, and for the readback
worker after its submit, `ops/pipeline.py`) over the delta of
`verifier.sigs`. None where the program has no such histogram."""


def read(r):
    h = r.window["histograms"].get("pipeline.wait_s")
    sigs = r.window["counters"].get("verifier.sigs", 0)
    return 1e6 * h["sum"] / sigs if h and sigs > 0 else None
