"""What a cell is, found by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic file ``traffic/<traffic>.json`` and one
reader ``metrics/<metric>.py`` per metric it reports; the mix's generator
``generators/<name>.py`` and the configuration's endpoint law
``laws/<name>.py`` are found the same way. A new cell, mix, generator,
law or metric is new files and entries; nothing here names one."""
from __future__ import annotations

import importlib.util
import json
import pathlib
from dataclasses import dataclass, field

__all__ = ["HERE", "ROOT", "Cell", "load_benchmark", "load_cell",
           "load_module", "load_reader"]

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)   # metric entries
    per_layer: list = field(default_factory=list)
    readers: dict = field(default_factory=dict)      # metric name -> module
    here: pathlib.Path = HERE    # the folder its generator and law are in


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(folder: str, name: str, here: pathlib.Path = HERE):
    """The module ``<here>/<folder>/<name>.py``."""
    path = here / folder / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no {folder} file {name!r} ({path})")
    key = f"bench_{folder}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, here: pathlib.Path = HERE):
    """The reader module ``metrics/<name>.py``: ``read(rec)`` gives the
    metric's value from a run's records, or None where there is nothing
    to read; an optional ``HOOK`` (module, attribute, function) is
    called with the arguments of each call of that program function in
    the traced run's roofline stretch, before the call."""
    return load_module("metrics", name, here)


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: pathlib.Path = ROOT,
              here: pathlib.Path = HERE) -> Cell:
    bench = load_benchmark(root)
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r}; have {sorted(wl)}")
    w = wl[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    per_layer = [m for m in bench["per_layer"] if _reports(m, name)]
    readers = {m["name"]: load_reader(m["name"], here)
               for m in e2e + per_layer}
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer,
                readers, here)
