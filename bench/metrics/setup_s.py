"""Process start to the first timed flush: imports, the stream's
generation, the kernels' build or load, the warm store and the window's
empty store (host clock)."""


def read(rec):
    return rec["setup_s"]
