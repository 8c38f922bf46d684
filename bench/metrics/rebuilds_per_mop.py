"""Global rebuilds (``SYNCS`` ``defrag_stream`` + ``defrag_dense``) per
million ops over the window."""


def read(rec):
    c, ops = rec["counters"], rec["window"]["ops"]
    return (c["defrag_stream"] + c["defrag_dense"]) / (ops / 1e6) \
        if ops else None
