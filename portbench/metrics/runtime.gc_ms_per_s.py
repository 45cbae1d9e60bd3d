"""Milliseconds of garbage-collector pauses a second of the window: the
delta of `runtime.gc_s`'s sum (each collection's pause, the program's
`gc.callbacks` watch, `utils/metrics.py`) over the window's seconds.
None where the program has no such watch."""


def read(r):
    h = r.window["histograms"].get("runtime.gc_s")
    return 1e3 * h["sum"] / r.seconds if h and r.seconds > 0 else None
