"""Process start to the window's start: imports, generating and signing
the traffic, the kernels' build where it is not cached, the backend, the
committee's registration and the warm-up (host clock)."""


def read(r):
    return r.setup_s
