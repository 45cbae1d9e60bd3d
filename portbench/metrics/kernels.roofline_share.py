"""The verification kernels' share of their roofline over the traced
seconds: the least time the card needs for the lanes verified there
(`yardstick.kernel_bound_s`, the frozen counts of each path's kernels:
generic K2, K3, K1, K4 on the `verifier.sigs` that were not committee
lanes, committee K2g, K5, K4 on `verifier.committee_sigs`, each chunk a
call) over the summed time of every kernel in the trace, in percent."""

from portbench import yardstick


def read(r):
    if r.trace is None or r.traced is None:
        return None
    kernel_s = sum(d for _, cat, _, d in r.trace["device"] if cat == "kernel") / 1e6
    c = r.traced["counters"]
    committee = c.get("verifier.committee_sigs", 0)
    generic = c.get("verifier.sigs", 0) - committee
    # Chunks of each path: K3 runs once a generic chunk, K5 once a committee chunk.
    calls = {name: sum(1 for n, cat, _, _ in r.trace["device"] if cat == "kernel" and name in n)
             for name in ("decompress_table_kernel", "committee_ladder_kernel")}
    if kernel_s <= 0 or generic + committee <= 0:
        return None
    bound = yardstick.kernel_bound_s("generic", generic, calls["decompress_table_kernel"])
    bound += yardstick.kernel_bound_s("committee", committee, calls["committee_ladder_kernel"], r.committee_size)
    return 100.0 * bound / kernel_s
