"""``torch.cuda.max_memory_allocated()`` over the run, read when the
window closes, in GiB. Not written for a run on the CPU."""


def read(rec):
    peak = rec["device"]["memory_peak_bytes"]
    return peak / 2 ** 30 if peak else None
