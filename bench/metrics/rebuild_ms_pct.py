"""The facade's rebuild span (``defrag_ms``: the whole flush that paid a
global rebuild) as a share of the ingest time, over the window's
unprofiled flushes."""


def read(rec):
    s = rec["spans"]
    return 100.0 * s["defrag_ms"] / s["ingest_ms"] if s["ingest_ms"] else None
