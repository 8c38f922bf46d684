"""Skewed endpoints: vertex index ``r`` (0-based rank) drawn with
probability proportional to ``(r + 1) ** -exponent``, by inverse CDF."""
import torch


def draw(g, n_vertices: int, size: int, exponent: float):
    dev = g.device
    cdf = torch.cumsum(torch.arange(1, n_vertices + 1, dtype=torch.float64,
                                    device=dev) ** -float(exponent), 0)
    u = torch.rand(size, generator=g, dtype=torch.float64, device=dev)
    x = torch.searchsorted(cdf, u * cdf[-1], right=True)
    return x.clamp_(max=n_vertices - 1).to(torch.int32)
