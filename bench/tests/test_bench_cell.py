"""Whole runs of a cell at a CPU test's size, through the plain kernels:
the rehearsal of a chip run, the control and the planted faults, each of
which has to come out not correct."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from bench.cell import run
from bench.reference import LIMITS
from bench.spec import ROOT

from .conftest import tiny

CELLS = ["lj.load", "u24.load"]


def values(out):
    return {k: c["value"] for k, c in out["checks"].items()}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_a_tiny_cell_runs_end_to_end(tiny_cell, cell, traced):
    c = tiny_cell(cell)
    out = run(c, 2 ** 31 + 17, 0.5, traced, device="cpu")
    assert out["correct"], values(out)
    assert set(values(out)) == set(LIMITS)
    assert list(out)[-2:] == ["checks", "rec"]
    rec = out["rec"]
    assert rec["window"]["ops"] == out["attempted"] > 0
    # the window holds whole cycles, so the store compared is a whole one
    assert rec["window"]["ops"] == \
        rec["window"]["cycles_done"] * c.config["edges"]
    assert out["failed"] == 0
    want = c.per_layer if traced else c.end_to_end
    got = set(out["metrics"])
    # CPU runs write no device metric
    device_only = {"peak_device_gib", "sort_lookup_ms_per_flush",
                   "append_roofline", "compact_rows_roofline",
                   "device_idle_pct", "launches_per_flush"}
    assert got == {m["name"] for m in want} - device_only
    if traced:
        assert rec["cycles"] and rec["cycles"][0]["memory_bytes"] > 0
        assert rec["hooks"]["append_roofline"]
        assert rec["hooks"]["compact_rows_roofline"]
        assert rec["profile"]["flushes"] == c.traffic["trace"]["flushes"]
    else:
        assert out["metrics"]["updates_per_s"]["value"] > 0


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_comes_out_not_correct(tiny_cell, seed):
    out = run(tiny_cell("lj.load"), seed, 0.2, False, device="cpu",
              control=True)
    assert not out["correct"]
    v = values(out)
    assert v["weights_off"] > 0
    assert v["pairs_missing"] == v["pairs_extra"] == 0


class Fault:
    """A store whose ``apply`` is broken underneath the harness."""

    def __init__(self, store, kind):
        self.store, self.kind = store, kind

    def __getattr__(self, name):
        return getattr(self.store, name)

    def apply(self, batch):
        from repro_torch.api import OpBatch
        if self.kind == "unchanged":
            res = self.store.apply(OpBatch.edges(batch.src[:0],
                                                 batch.dst[:0]))
            return type(res)(len(batch), 0)
        if self.kind == "half":
            h = len(batch) // 2
            res = self.store.apply(OpBatch.edges(
                batch.src[:h], batch.dst[:h], batch.weight[:h]))
            return type(res)(len(batch), 0)
        if self.kind == "deletes_ignored":
            keep = batch.weight != 0
            res = self.store.apply(OpBatch.edges(
                batch.src[keep], batch.dst[keep], batch.weight[keep]))
            return type(res)(len(batch), 0)
        if self.kind == "altered":
            w = batch.weight.copy()
            w[len(w) // 3] = np.float32(w[len(w) // 3] * 1.5)
            return self.store.apply(OpBatch.edges(batch.src, batch.dst, w))
        raise ValueError(self.kind)


@pytest.mark.parametrize("kind,number", [("unchanged", "edges_off"),
                                         ("half", "pairs_missing"),
                                         ("altered", "weights_off")])
def test_a_fault_underneath_comes_out_not_correct(tiny_cell, kind, number):
    out = run(tiny_cell("lj.load"), 5, 0.2, False, device="cpu",
              wrap_store=lambda s: Fault(s, kind))
    assert not out["correct"]
    assert values(out)[number] > 0


def test_the_result_line_comes_last(tmp_path):
    """The command's own output on a run at the test size: stderr ends
    with the numbers compared, stdout with the result object (run through
    a script that skips the look for a card)."""
    script = tmp_path / "drive.py"
    script.write_text(
        "import json, sys\n"
        f"sys.path[0:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "import bench.run as r\n"
        "from bench.tests.conftest import tiny\n"
        "import bench.spec as spec, bench.cell as cell\n"
        "load = spec.load_cell\n"
        "spec.load_cell = lambda n: tiny(load(n))\n"
        "real = cell.run\n"
        "cell.run = lambda *a, **k: real(*a, **dict(k, device='cpu'))\n"
        "import torch\n"
        "torch.cuda.device_count = lambda: 1\n"
        "torch.cuda.is_available = lambda: True\n"
        "sys.exit(r.main(sys.argv[1:]))\n")
    env = dict(os.environ, REPRO_NO_JAX_SHIM="1")
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, str(script), "--workload",
                        "u24.load", "--seed", "4", "--seconds", "0.3"],
                       capture_output=True, text=True, timeout=600, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks" and line["correct"]
    tail = p.stderr.strip().splitlines()[-len(LIMITS):]
    assert [t.split()[1] for t in tail] == list(LIMITS)


@pytest.mark.cuda
def test_a_tiny_cell_on_the_card(tiny_cell, card):
    for traced in (False, True):
        out = run(tiny_cell("lj.load"), 7, 0.5, traced, device="cuda")
        assert out["correct"], values(out)
        assert out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
    assert "launches_per_flush" in out["metrics"]
