"""The edge pool's host round trips (``SYNCS["host_syncs"]``) per flush
over the window."""


def read(rec):
    n = rec["window"]["flushes"]
    return rec["counters"]["host_syncs"] / n if n else None
