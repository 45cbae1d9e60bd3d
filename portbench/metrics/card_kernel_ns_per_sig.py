"""Nanoseconds of kernel time on the card a verified signature: every
kernel the profiler saw from the window's opening until its last group
was answered, summed, over every signature those groups were answered
for (both lanes, every route). None where the window was not profiled."""


def read(r):
    if r.window_device is None:
        return None
    kernel_us = sum(d for _, cat, _, d in r.window_device if cat == "kernel")
    sigs = sum(len(rec.mask) for rec in r.records if rec.mask is not None)
    if kernel_us <= 0 or sigs == 0:
        return None
    return 1e3 * kernel_us / sigs
