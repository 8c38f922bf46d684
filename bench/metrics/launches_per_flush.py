"""Kernel launches (the runtime's launch calls in the profiled stretch)
per flush."""


def read(rec):
    p = rec.get("profile") or {}
    return p["launches"] / p["flushes"] if p.get("launches") else None
