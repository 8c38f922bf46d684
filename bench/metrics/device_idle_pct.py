"""The share of the profiled stretch in which no kernel, copy or fill ran
on the device: 100 less the union of the device events over the window."""


def read(rec):
    p = rec.get("profile") or {}
    if not p.get("busy_s"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
