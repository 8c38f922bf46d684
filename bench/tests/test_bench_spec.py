"""The benchmark's files against the contract that ``BENCHMARK.json``
must meet, and the harness finding a new cell, mix and metric by name."""
import json
import re
import shutil

import pytest

from bench.spec import HERE, ROOT, load_benchmark, load_cell, load_reader

from .conftest import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = load_benchmark()
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"]
    assert BENCH["command"][1].startswith("bench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    names = [m["name"] for m in METRICS] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_file_of_a_cell_parses(cell):
    c = load_cell(cell)
    entry = {x["name"]: x for x in BENCH["configs"]}[
        {w["name"]: w for w in BENCH["workloads"]}[cell]["config"]]
    assert c.config["name"] == entry["name"]
    assert c.config["reduced"] == entry["reduced"]
    assert c.config["edges"] % c.config["store"]["batch"] == 0
    assert c.traffic["generator"] == "load"
    for m in c.end_to_end + c.per_layer:
        assert callable(c.readers[m["name"]].read)
    # every cell reports set-up, another end-to-end metric and a layer's
    assert "setup_s" in c.readers and len(c.end_to_end) >= 2
    assert c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_layer_metric_moves_a_metric_its_cells_report(metric):
    m = {x["name"]: x for x in BENCH["per_layer"]}[metric]
    for cell in m.get("workloads", [w["name"] for w in BENCH["workloads"]]):
        c = load_cell(cell)
        assert m["moves"] in [e["name"] for e in c.end_to_end], cell


def test_one_layer_name_per_layer():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    for layer in layers:
        assert "\n" not in layer and 1 <= len(layer) <= 200
    # metrics of one module share its layer name letter for letter
    by_module = {}
    for m in BENCH["per_layer"]:
        by_module.setdefault(m["layer"].split(" (")[0], set()).add(
            m["layer"])
    assert all(len(v) == 1 for v in by_module.values())


def test_a_new_cell_mix_and_metric_are_files_and_entries(tmp_path):
    """A throwaway configuration, traffic mix and metric, added as new
    files and entries in a copy, run without an edit to any file."""
    root = tmp_path / "repo"
    shutil.copytree(HERE, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((HERE / "configs" / "u24-b64k.json").read_text())
    cfg.update(name="x-tiny", vertices=3000)
    cfg["endpoints"] = {"law": "first_few", "k": 50}
    (root / "bench" / "configs" / "x-tiny.json").write_text(json.dumps(cfg))
    (root / "bench" / "laws" / "first_few.py").write_text(
        "import torch\n"
        "def draw(g, n_vertices, size, k):\n"
        "    return torch.randint(0, k, (size,), generator=g,\n"
        "                         dtype=torch.int32, device=g.device)\n")
    mix = json.loads((HERE / "traffic" / "load.json").read_text())
    mix.update(generator="halves", weight_range=[1.0, 1.5])
    (root / "bench" / "traffic" / "light.json").write_text(json.dumps(mix))
    (root / "bench" / "generators" / "halves.py").write_text(
        "from bench.streams import endpoints, generator, vertex_ids, Stream\n"
        "import numpy as np\n"
        "def make(config, traffic, seed, device, here):\n"
        "    n, ops = config['vertices'], config['edges']\n"
        "    g = generator(seed, device)\n"
        "    si = endpoints(g, config['endpoints'], n, ops, here=here)\n"
        "    di = endpoints(g, config['endpoints'], n, ops, here=here)\n"
        "    w = np.full(ops, 1.25, np.float32)\n"
        "    ids = vertex_ids(n, seed)\n"
        "    return Stream(ids, si, di, w, ids[si], ids[di])\n")
    (root / "bench" / "metrics" / "ops_per_flush.py").write_text(
        "def read(rec):\n"
        "    return rec['window']['ops'] / rec['window']['flushes']\n")
    bench["configs"].append({"name": "x-tiny", "source": "test",
                             "file": "bench/configs/x-tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "x.light", "config": "x-tiny",
                               "traffic": "light", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "ops_per_flush", "unit": "ops",
                               "better": "higher",
                               "source": "program_counter", "layer": "t",
                               "moves": "updates_per_s",
                               "workloads": ["x.light"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = tiny(load_cell("x.light", root=root, here=root / "bench"))
    assert cell.config["vertices"] == 5000
    assert cell.traffic["generator"] == "halves"
    from bench.cell import run
    out = run(cell, 11, 0.1, True, device="cpu")
    assert out["correct"]
    assert out["metrics"]["ops_per_flush"]["value"] == 1024
    # the throwaway law touched only its 50 vertices
    assert out["rec"]["cycles"][0]["num_vertices"] <= 50
    # the cells that were there do not report it
    assert "ops_per_flush" not in load_cell("lj.load", root=root,
                                            here=root / "bench").readers


class _Clock:
    """A host clock that moves 10 ms each time it is read."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.01
        return self.t


@pytest.mark.parametrize("fault", [None, "deletes_ignored"])
def test_a_preload_mix_without_remakes_is_files_and_entries(
        tmp_path, monkeypatch, fault):
    """A throwaway mix that preloads every store in set-up and replays its
    cycle on the same store (tombstones and weight updates of preloaded
    pairs), added as a generator, a traffic file and an entry in a copy.
    The store compared holds preload and every replay; a store that
    ignores the tombstones comes out not correct."""
    root = tmp_path / "repo"
    shutil.copytree(HERE, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((HERE / "traffic" / "load.json").read_text())
    mix.update(generator="churn_lite", why="test")
    (root / "bench" / "traffic" / "churn_lite.json").write_text(
        json.dumps(mix))
    (root / "bench" / "generators" / "churn_lite.py").write_text(
        "import numpy as np\n"
        "from bench.streams import Mix, Stream, endpoints, generator, "
        "vertex_ids\n"
        "def make(config, traffic, seed, device, here):\n"
        "    n, m = config['vertices'], config['edges']\n"
        "    g = generator(seed, device)\n"
        "    si = endpoints(g, config['endpoints'], n, m, here=here)\n"
        "    di = endpoints(g, config['endpoints'], n, m, here=here)\n"
        "    ids = vertex_ids(n, seed)\n"
        "    w = np.full(m, 1.5, np.float32)\n"
        "    pre = Stream(ids, si, di, w, ids[si], ids[di])\n"
        "    h = m // 2\n"
        "    # half tombstones of preloaded pairs, half weight updates\n"
        "    cw = np.concatenate([np.zeros(h, np.float32),\n"
        "                         np.full(m - h, 0.75, np.float32)])\n"
        "    ops = Stream(ids, si, di, cw, ids[si], ids[di])\n"
        "    return Mix(ops, preload=pre, remake=False)\n")
    bench["workloads"].append({"name": "lj.churn_lite", "config": "lj-b64k",
                               "traffic": "churn_lite", "chips": 1,
                               "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = tiny(load_cell("lj.churn_lite", root=root, here=root / "bench"))
    # the snapshot's pad holds every live edge the store can hold, as a
    # configuration's does (the tiny load store's holds one cycle's)
    cell.config["store"]["m_cap"] = 2 * cell.config["edges"]
    from bench import cell as cell_mod
    from bench.tests.test_bench_cell import Fault
    monkeypatch.setattr(cell_mod, "time", _Clock())
    out = cell_mod.run(cell, 13, 0.5, False, device="cpu",
                       wrap_store=(lambda s: Fault(s, fault)) if fault
                       else None)
    rec = out["rec"]
    # whole cycles only, more than one, each on the same store
    assert rec["window"]["cycles_done"] >= 2
    assert rec["window"]["ops"] == \
        rec["window"]["cycles_done"] * cell.config["edges"]
    assert rec["window"]["remake_s"] > 0
    checks = {k: c["value"] for k, c in out["checks"].items()}
    if fault:
        assert not out["correct"] and checks["pairs_extra"] > 0
        return
    assert out["correct"], checks
    # the preload is in the store: the replays deleted part of it
    e = [c["num_edges"] for c in rec["cycles"]]
    assert len(set(e)) == 1 and 0 < e[0] < cell.config["edges"]


def test_readers_load_by_name():
    for m in METRICS:
        assert callable(load_reader(m["name"]).read)
    with pytest.raises(ValueError):
        load_reader("no_such_metric")
