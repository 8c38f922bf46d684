"""Multi-pod dry run of the LM stack on placeholder ranks (counterpart of
``repro.launch.dryrun``): every (architecture x shape x mesh) cell is
traced on fake DTensors over the 16 x 16 or 2 x 16 x 16 production mesh
of a fake process group (``launch.mesh.make_placeholder_mesh``), and its
per-device cost is recorded by ``launch.costs.CostCounter``. Nothing is
computed on any device: every tensor is a ``FakeTensor`` (shapes and
dtypes only), every collective a record.

The cell is the JAX tool's: the same rules (``TRAIN_RULES``,
``SERVE_RULES`` or ``MOE_SERVE_RULES``, with ``VARIANTS``), the same
optimizer (AdamW, Adafactor for MoE) with its state specs, the same
input and cache shardings; it runs the train step, or ``prefill`` /
``decode`` with the cache. Where the JAX tool lowers and compiles, this
one executes the program's ops on fake tensors, so it counts the branch
each op takes (``costs.BRANCH_RULE``).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all            # 40 cells x 2 meshes
  python -m repro_torch.launch.dryrun --all --mesh single

Records land in ``benchmarks/results/dryrun/torch-<arch>__<shape>__<mesh>
.json`` with the JAX records' keys (``trace_s`` in place of
``lower_s`` / ``compile_s``), plus ``argument_bytes`` by part and the
counter's rules. A cell that cannot be traced (an op with no DTensor
strategy) is recorded as ``"status": "fail"`` with the error, which
names the op.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import sys
import time
import traceback

import torch

from ..configs import ARCH_IDS, SHAPES, get_arch
from ..dist.sharding import (MOE_SERVE_RULES, SERVE_RULES, TRAIN_RULES,
                             VARIANTS, ShardingRules, mesh_sizes,
                             param_partition_specs, placements_for,
                             set_rules, spec_for)
from ..models.api import (build_model, cache_map, cache_specs,
                          input_specs, param_counts, shapes_and_logical)
from ..train import adafactor, adamw, cosine_schedule, make_train_step
from ..train.step import TrainState
from ..tree import leaves, tree_map
from . import costs
from .mesh import make_placeholder_mesh

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "benchmarks" / \
    "results" / "dryrun"
MEMORY_RULE = ("argument: the cell's arguments' local shard bytes; "
               "output: the returned tensors' local bytes; alias: those "
               "of them that share storage with an argument (updated in "
               "place, JAX's donation); temp: " + costs.TEMP_RULE)


def _axes(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape, spec, mesh):
    """A device's shard shape of a tensor of ``shape`` under ``spec``
    (``spec_for`` shards only dims its axes divide)."""
    sizes = mesh_sizes(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // math.prod(sizes[a] for a in _axes(e))
                 for d, e in zip(shape, spec))


def local_bytes(t, spec, mesh) -> int:
    return math.prod(local_shape(t.shape, spec, mesh)) * t.element_size()


def _opt_state_specs(opt_state, params, pspecs):
    """Optimizer-state specs, the JAX tool's rule: moments inherit the
    spec of the first param of their shape; Adafactor's factored ``vr`` /
    ``vc`` drop the last / second-to-last dim of a param's spec."""
    pflat = leaves(params)
    specflat = _spec_leaves(pspecs)

    def leaf_spec(leaf):
        for p, s in zip(pflat, specflat):
            if tuple(p.shape) == tuple(leaf.shape):
                return s
        for p, s in zip(pflat, specflat):
            if p.dim() == leaf.dim() + 1:
                if tuple(p.shape[:-1]) == tuple(leaf.shape):
                    return tuple(s)[:-1]
                if tuple(p.shape[:-2] + p.shape[-1:]) == tuple(leaf.shape):
                    return tuple(s)[:-2] + tuple(s)[-1:]
        return ()

    return tree_map(leaf_spec, opt_state)


def _spec_leaves(specs):
    """The spec tuples of a spec tree, in ``tree.leaves`` order (a spec
    is a tuple: it is a leaf here, not a container)."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    return [specs]


def _input_spec(name, t, rules, mesh):
    """The JAX tool's input shardings, by input name."""
    n = t.dim()
    if name in ("tokens", "labels"):
        lg = ("batch", None)
    elif name == "positions":
        lg = (None, "batch", None) if n == 3 else ("batch", None)
    elif name == "frames":
        lg = ("batch", "act_seq", None)
    elif name in ("token", "pos"):
        lg = ("batch",)
    elif name == "enc_out":
        lg = ("batch", None, None)
    else:
        return ()
    return spec_for(t.shape, lg, rules, mesh)


def _cache_spec(t, rules, mesh):
    """The JAX tool's cache rule: K/V leaves (rank >= 4) on batch,
    cache_seq and kv_heads; every other leaf replicated."""
    n = t.dim()
    if n >= 4:
        lg = [None] * n
        lg[-4], lg[-3], lg[-2] = "batch", "cache_seq", "kv_heads"
        return spec_for(t.shape, lg, rules, mesh)
    return ()


def plan_cell(cfg, kind: str, seq: int, batch: int, rules, mesh):
    """Every argument of a cell as (part, meta tensor, spec) with the
    tree it belongs to: params, optimizer state and step (train), or
    the cache (serve), and the batch. Nothing is allocated."""
    pshapes, logical = shapes_and_logical(cfg)
    pspecs = param_partition_specs(pshapes, logical, rules, mesh)
    specs = input_specs(cfg, kind, seq, batch)
    bspecs = {k: _input_spec(k, v, rules, mesh) for k, v in specs.items()}
    plan = {"params": (pshapes, pspecs), "batch": (specs, bspecs)}
    if kind == "train":
        opt = _optimizer(cfg)
        ost = opt.init(pshapes)
        plan["opt_state"] = (ost, _opt_state_specs(ost, pshapes, pspecs))
        plan["step"] = (torch.empty((), dtype=torch.int32, device="meta"),
                        ())
    else:
        c = cache_specs(cfg, batch, seq)
        plan["cache"] = (c, cache_map(lambda t: _cache_spec(t, rules, mesh),
                                      c))
    return plan


def _optimizer(cfg):
    if cfg.family == "moe":
        return adafactor(cosine_schedule(1e-4, 100, 10000))
    return adamw(cosine_schedule(3e-4, 100, 10000))


def _pairs(tree, specs):
    """(meta tensor, spec) pairs of a tree and its parallel spec tree."""
    if isinstance(tree, torch.Tensor):
        return [(tree, specs)]
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _pairs(tree[k], specs[k])]
    if tree is None:
        return []
    return [p for t, s in zip(tree, specs) for p in _pairs(t, s)]


def argument_bytes(plan, mesh) -> dict:
    """Per-device bytes of each part of the arguments (its local shards)."""
    return {part: sum(local_bytes(t, s, mesh) for t, s in _pairs(*ts))
            for part, ts in plan.items()}


def _fake(tree, specs, mesh):
    """A tree of fake DTensors (under an active ``FakeTensorMode``) in the
    shapes, dtypes and placements of a meta tree and its specs."""
    from torch.distributed.tensor import DTensor

    def one(t, spec):
        local = torch.empty(local_shape(t.shape, spec, mesh), dtype=t.dtype)
        return DTensor.from_local(local, mesh, placements_for(spec, mesh),
                                  run_check=False, shape=t.shape,
                                  stride=torch.empty(t.shape,
                                                     device="meta").stride())

    if isinstance(tree, torch.Tensor):
        return one(tree, specs)
    if isinstance(tree, dict):
        return {k: _fake(v, specs[k], mesh) for k, v in tree.items()}
    if tree is None:
        return None
    out = [_fake(t, s, mesh) for t, s in zip(tree, specs)]
    return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)


def _local_tensors(x):
    from torch.distributed.tensor import DTensor
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in costs._tensors(x)]


_FAKE_MODE = []


def _fake_mode():
    """The process's one ``FakeTensorMode``: DTensor caches sharding
    decisions with the fake tensors they saw, so every cell of a process
    shares one mode."""
    if not _FAKE_MODE:
        from torch._subclasses.fake_tensor import FakeTensorMode
        _FAKE_MODE.append(FakeTensorMode())
    return _FAKE_MODE[0]


def trace_cell(cfg, kind: str, plan, rules, mesh, counter):
    """Run the cell's program on fake DTensors under ``counter`` (a
    ``costs.CostCounter``). Returns (output bytes, alias bytes)."""
    from torch.distributed.tensor.experimental import implicit_replication
    model = build_model(cfg)
    with _fake_mode():
        args = {part: _fake(*ts, mesh) for part, ts in plan.items()}
        arg_storages = {t.untyped_storage()._cdata
                        for t in _local_tensors(list(args.values()))}
        # a plain tensor the program makes (positions, masks) meets the
        # DTensors as replicated, as a JAX constant does
        with set_rules(rules, mesh), implicit_replication(), counter:
            if kind == "train":
                step_fn = make_train_step(model, _optimizer(cfg))
                state = TrainState(params=args["params"],
                                   opt_state=args["opt_state"],
                                   step=args["step"])
                out = step_fn(state, args["batch"])
            else:
                fn = model.prefill if kind == "prefill" else model.decode
                out = fn(args["params"], args["batch"], args["cache"])
        outs = _local_tensors(out)
        out_b = sum(t.numel() * t.element_size() for t in outs)
        alias_b = sum(t.numel() * t.element_size() for t in outs
                      if t.untyped_storage()._cdata in arg_storages)
    return out_b, alias_b


def _cell_rules(cfg, kind, variant):
    rule_over, _ = VARIANTS[variant]
    if kind == "train":
        rules = TRAIN_RULES
    elif cfg.family == "moe":
        rules = MOE_SERVE_RULES
    else:
        rules = SERVE_RULES
    return ShardingRules({**rules, **rule_over})


def _mesh(mesh_name):
    """"single" / "multi", or "local": a 1 x 1 mesh (one card)."""
    if mesh_name == "local":
        return make_placeholder_mesh(shape=(1, 1), axes=("data", "model"))
    if isinstance(mesh_name, str):
        return make_placeholder_mesh(multi_pod=mesh_name == "multi")
    sizes, axes = mesh_name
    return make_placeholder_mesh(shape=sizes, axes=axes)


def run_cell(arch: str, shape: str, mesh_name="single", save: bool = True,
             variant: str = "baseline", smoke: bool = False,
             seq: int | None = None, batch: int | None = None):
    """Trace one cell and return its record. ``mesh_name``: "single",
    "multi", "local" (1 x 1) or (sizes, axes); ``smoke`` takes the arch's
    SMOKE config; ``seq`` / ``batch`` replace the shape's."""
    mod = get_arch(arch)
    _, cfg_over = VARIANTS[variant]
    mname = mesh_name if isinstance(mesh_name, str) else \
        "x".join(map(str, mesh_name[0]))
    mname += "" if variant == "baseline" else f"+{variant}"
    skip = getattr(mod, "SKIPS", {}).get(shape)
    if skip and not smoke:
        rec = {"arch": arch, "shape": shape, "mesh": mname,
               "status": "skip", "reason": skip}
        if save:
            _save(rec)
        print(f"[SKIP] {arch} x {shape}: {skip}")
        return rec
    cfg = dataclasses.replace(mod.SMOKE if smoke else mod.CONFIG,
                              **cfg_over)
    kind, s0, b0 = SHAPES[shape]
    seq, batch = seq or s0, batch or b0
    mesh = _mesh(mesh_name)
    chips = mesh.size()
    rules = _cell_rules(cfg, kind, variant)
    plan = plan_cell(cfg, kind, seq, batch, rules, mesh)
    abytes = argument_bytes(plan, mesh)
    tot, act = param_counts(cfg)
    rec = {
        "arch": arch, "shape": shape, "mesh": mname, "variant": variant,
        "kind": kind, "seq": seq, "batch": batch, "chips": chips,
        "smoke": smoke, "params_total": int(tot), "params_active": int(act),
        "argument_bytes": abytes,
    }
    t0 = time.time()
    counter = costs.CostCounter()
    try:
        out_b, alias_b = trace_cell(cfg, kind, plan, rules, mesh, counter)
    except Exception as e:  # noqa: BLE001 — a cell that cannot be traced
        traceback.print_exc()
        rec.update(status="fail", error=f"{type(e).__name__}: {e}"[:800],
                   failed_op=counter.last_op,
                   trace_s=round(time.time() - t0, 1))
        if save:
            _save(rec)
        print(f"[FAIL] {arch} x {shape} x {mname}: {rec['error'][:300]}")
        return rec
    rec.update(status="ok", trace_s=round(time.time() - t0, 1),
               **counter.record())
    rec["memory"] = {
        "argument_size_in_bytes": int(sum(abytes.values())),
        "output_size_in_bytes": int(out_b),
        "temp_size_in_bytes": int(counter.peak),
        "alias_size_in_bytes": int(alias_b),
    }
    rec["memory_rule"] = MEMORY_RULE
    if save:
        _save(rec)
    mm = rec["memory"]["argument_size_in_bytes"] + \
        rec["memory"]["temp_size_in_bytes"]
    print(f"[OK] {arch} x {shape} x {mname}: trace {rec['trace_s']:.0f}s, "
          f"flops/dev {rec['flops']:.3g}, args+temp/dev {mm / 2**30:.2f} "
          f"GiB, coll {sum(rec['collective_bytes'].values()) / 2**20:.1f} "
          "MiB")
    return rec


def _save(rec):
    RESULTS.mkdir(parents=True, exist_ok=True)
    p = RESULTS / f"torch-{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    p.write_text(json.dumps(rec, indent=1))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both", "local"),
                    default="both",
                    help="'local': a 1 x 1 mesh (one card)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's SMOKE config")
    ap.add_argument("--seq", type=int, default=None,
                    help="replace the shape's sequence length")
    ap.add_argument("--batch", type=int, default=None,
                    help="replace the shape's global batch")
    args = ap.parse_args(argv)

    meshes = {"single": ["single"], "multi": ["multi"], "local": ["local"],
              "both": ["single", "multi"]}[args.mesh]
    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")

    failures = []
    for a, s in cells:
        for m in meshes:
            try:
                rec = run_cell(a, s, m, variant=args.variant,
                               smoke=args.smoke, seq=args.seq,
                               batch=args.batch)
            except Exception as e:  # noqa: BLE001 — report and continue
                traceback.print_exc()
                rec = {"arch": a, "shape": s, "mesh": m, "status": "fail",
                       "error": str(e)[:500]}
                _save(rec)
            if rec["status"] == "fail":
                failures.append((a, s, m, rec["error"][:200]))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print("\nAll dry-run cells traced.")


if __name__ == "__main__":
    main()
