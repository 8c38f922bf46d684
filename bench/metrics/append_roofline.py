"""The append kernel's share of its roofline over the roofline stretch:
the least time its calls need on the chip (``bench.work.append_bound``,
from each call's inputs before the call) over their device time."""
from bench.trace import kernel_seconds
from bench.work import append_bound

HOOK = ("repro_torch.kernels.ops", "append_edges", append_bound)


def read(rec):
    s = kernel_seconds(rec.get("roofline"), rec.get("roofline_launches", {}),
                       ("append_kernel",), "append")
    bounds = rec["hooks"].get("append_roofline")
    return None if not s or not bounds else 100.0 * sum(bounds) / s
