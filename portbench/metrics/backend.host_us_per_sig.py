"""Microseconds of the backend seam's own host work a signature on the
card: the window's deltas of `backend.generic_s` and `backend.committee_s`
summed, less the delta of `verifier.e2e_s` that they enclose
(`crypto/torch_backend.py`: the lists handed to the verifier, `.data`,
the mask's `.tolist()`), over the delta of `crypto.tpu_sigs`. None where
the program has no such spans."""


def read(r):
    h, c = r.window["histograms"], r.window["counters"]
    spans = [h[name]["sum"] for name in ("backend.generic_s", "backend.committee_s") if name in h]
    e2e = h.get("verifier.e2e_s")
    sigs = c.get("crypto.tpu_sigs", 0)
    if not spans or e2e is None or sigs <= 0:
        return None
    return 1e6 * (sum(spans) - e2e["sum"]) / sigs
