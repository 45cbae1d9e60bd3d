"""Milliseconds a critical (consensus) backend call spends reaching its
worker thread and getting back to the event loop, the mean over the
window: the delta of `service.handoff_critical_s`'s sum over its count
(`crypto/batch_service.py`). What a QC's check pays for the hand-off
under the flood. None where the program has no such histogram or the
window made no critical call."""


def read(r):
    h = r.window["histograms"].get("service.handoff_critical_s")
    return 1e3 * h["sum"] / h["count"] if h and h["count"] > 0 else None
