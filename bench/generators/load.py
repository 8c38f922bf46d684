"""The bulk-load generator: one cycle is ``config["edges"]`` inserts over
``config["vertices"]`` vertices, both endpoints drawn by the
configuration's law, weights uniform in ``traffic["weight_range"]``
(never 0, the tombstone), loaded into a new empty store each cycle."""
import torch

from bench.streams import Mix, Stream, endpoints, generator, vertex_ids


def make(config: dict, traffic: dict, seed: int, device, here) -> Mix:
    n, ops = int(config["vertices"]), int(config["edges"])
    g = generator(seed, device)
    si = endpoints(g, config["endpoints"], n, ops, here)
    di = endpoints(g, config["endpoints"], n, ops, here)
    lo, hi = traffic["weight_range"]
    w = (torch.rand(ops, generator=g, device=g.device) * (hi - lo) + lo) \
        .cpu().numpy()
    ids = vertex_ids(n, seed)
    return Mix(Stream(ids, si, di, w, ids[si], ids[di]), preload=None,
               remake=True)
