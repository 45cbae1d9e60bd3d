"""Signatures whose mask came back inside the window, on every lane and
every route, over the window's seconds (host clock), as the service's
callers see them. Read in the traced run, whose window is not profiled."""

from portbench import yardstick


def read(r):
    done = sum(len(rec.mask) for rec in r.records if rec.mask is not None and rec.t_done <= r.seconds)
    return yardstick.rate(done, r.seconds)
