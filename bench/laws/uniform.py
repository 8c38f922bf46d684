"""Uniform endpoints over the vertex indices."""
import torch


def draw(g, n_vertices: int, size: int):
    return torch.randint(0, n_vertices, (size,), generator=g,
                         dtype=torch.int32, device=g.device)
