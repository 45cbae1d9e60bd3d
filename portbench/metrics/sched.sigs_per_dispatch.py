"""Mean signatures in a bulk bucket the scheduler dispatched in the
window: the delta of `scheduler.bucket_size`'s sum over its count."""


def read(r):
    h = r.window["histograms"].get("scheduler.bucket_size")
    return h["sum"] / h["count"] if h and h["count"] > 0 else None
