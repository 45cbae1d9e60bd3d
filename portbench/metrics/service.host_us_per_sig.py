"""Microseconds of the service's own host work a verified signature: the
window's deltas of `service.submit_s`, `service.assemble_s` and
`service.resolve_s` summed (`crypto/batch_service.py`: admission, each
dispatch's lists and dedup scan, each call's resolution), over the delta
of the signatures the backend verified on either route (`crypto.tpu_sigs`
+ `crypto.cpu_sigs`). None where the program has no such spans."""

SPANS = ("service.submit_s", "service.assemble_s", "service.resolve_s")


def read(r):
    h, c = r.window["histograms"], r.window["counters"]
    if not all(name in h for name in SPANS):
        return None
    sigs = c.get("crypto.tpu_sigs", 0) + c.get("crypto.cpu_sigs", 0)
    return 1e6 * sum(h[name]["sum"] for name in SPANS) / sigs if sigs > 0 else None
