"""The log-compaction kernel's (``compact_rows``) share of its roofline
over the roofline stretch: the least time its calls need on the chip
(``bench.work.compact_rows_bound``) over their device time."""
from bench.trace import kernel_seconds
from bench.work import compact_rows_bound

HOOK = ("repro_torch.kernels.ops", "compact_rows", compact_rows_bound)


def read(rec):
    s = kernel_seconds(rec.get("roofline"), rec.get("roofline_launches", {}),
                       ("compact_hash_kernel", "compact_sort_kernel"),
                       "compact_rows")
    bounds = rec["hooks"].get("compact_rows_roofline")
    return None if not s or not bounds else 100.0 * sum(bounds) / s
