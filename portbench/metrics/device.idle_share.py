"""The share of the traced window in which no kernel or copy ran on the
card: one less the union of the device's intervals over the window, in
percent."""


def read(r):
    if r.trace is None:
        return None
    window = r.trace["hi_us"] - r.trace["lo_us"]
    if window <= 0:
        return None
    return 100.0 * (1.0 - sum(b - a for a, b in r.trace["busy"]) / window)
