"""Shared helpers of the benchmark's tests: a cell cut to a size the CPU
runs in a second, and the card fixture of the tests marked ``cuda``."""
from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC = os.path.join(ROOT, "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

TINY = {"vertices": 5000, "edges": 8192}
TINY_STORE = dict(n_max=8192, expected_n=5000, pool_blocks=4096,
                  batch=1024, k_max=64, k_big=4, m_cap=8192)


def tiny(cell):
    """``cell`` at a CPU test's size: 8 flushes of 1,024 a cycle over
    5,000 vertices, two flushes a traced stretch."""
    cell.config.update(TINY)
    cell.config["store"].update(TINY_STORE)
    cell.traffic["trace"]["flushes"] = 2
    return cell


@pytest.fixture
def tiny_cell():
    from bench.spec import load_cell
    return lambda name: tiny(load_cell(name))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")
