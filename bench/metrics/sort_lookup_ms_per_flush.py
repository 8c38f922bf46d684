"""Device ms per flush of the SORT descent kernel (``sort_lookup``), from
the profiled stretch; dropped events are made up from the program's
launch counter."""
from bench.trace import kernel_seconds


def read(rec):
    p = rec.get("profile")
    s = kernel_seconds(p, rec.get("profile_launches", {}),
                       ("sort_lookup_kernel",), "sort_lookup")
    return None if s is None else s * 1e3 / p["flushes"]
