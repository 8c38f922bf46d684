"""Ops acknowledged over the summed time of the window's flushes, submit
to acknowledgement (host clock); a store's re-make between cycles is not
ingest time."""


def read(rec):
    w = rec["window"]
    return w["ops"] / w["ingest_s"] if w["ingest_s"] > 0 else None
