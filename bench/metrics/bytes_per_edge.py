"""``RadixGraph.memory_bytes()`` (the paper's accounting: SORT slots,
vertex rows, occupied edge blocks) over the live edges, at the end of the
first cycle: a fixed op count, whatever the rate."""


def read(rec):
    c = rec["cycles"][0] if rec["cycles"] else {}
    if not c.get("memory_bytes") or not c.get("num_edges"):
        return None
    return c["memory_bytes"] / c["num_edges"]
