"""setup_s (s): from the process's start to the window's: imports, the
kernel libraries (built once a checkout), weights, restored state and
warm-up (host clock)."""


def read(rec):
    return rec.setup_s
