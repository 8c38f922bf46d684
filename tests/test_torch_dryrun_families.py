"""The LM dry run on the MoE, SSM and hybrid families: the ops written per
rank for a ``DeviceMesh`` (``repro_torch.dist.local_ops``: ``moe_dense``,
``ssd_local``, ``rglru_local``, ``roll_local``, ``reduced``) and the
full-width cells they let ``repro_torch.launch.dryrun`` trace.

* the program the dry run traces, run on real DTensors over 4 gloo ranks
  on a 2 x 2 and a 1 x 4 (data, model) mesh in float64, equals the plain
  single-process program: kimi-k2-1t-a32b, mamba2-1.3b and
  recurrentgemma-9b SMOKE, the train loss, every gradient, a prefill's
  logits, a decode's logits and every cache leaf after it; kimi's dense
  dispatch keeps the same (token, slot) pairs and drops the same ones;
* cells that could not be traced at their full ``CONFIG`` (the dense MoE
  dispatch of kimi-k2 and llama4-maverick training, mamba2's chunk scan,
  the hybrid and whisper prefills) trace ``ok`` on the 16 x 16 mesh, at
  a shorter sequence and batch that keep the same code path;
* a SMOKE MoE, SSM and hybrid train cell's per-device FLOPs x devices on
  a data-only mesh of 4 equal ``FlopCounterMode`` of the whole train step
  on CPU tensors: no rank does the whole work.

The fake process group of the dry run is global to a process, so every
run is a subprocess; all of them start at once.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
ARCHS = ("kimi-k2-1t-a32b", "mamba2-1.3b", "recurrentgemma-9b")
MESHES = ((2, 2), (1, 4))
B, S = 4, 24            # S > the hybrid SMOKE window (16): the ring roll

# full-width cells that failed to trace (ROADMAP "Dry-run cells"), at a
# cut that keeps their code path: a batch of 16 is one row a data rank
# (256 and 32 are 16 and 2); a train sequence of 512 is one attention
# block, two SSD chunks of 256 and one loss chunk; the hybrid prefill's
# 2,560 positions pass its 2,048-wide window, so the ring cache is
# written by a roll (of 512); whisper's encoder sees 512 frames
CUT_CELLS = {
    "kimi-k2-1t-a32b|train_4k": (512, 16),
    "llama4-maverick-400b-a17b|train_4k": (512, 16),
    "mamba2-1.3b|train_4k": (512, 16),
    "mamba2-1.3b|prefill_32k": (512, 16),
    "recurrentgemma-9b|prefill_32k": (2560, 16),
    "whisper-small|prefill_32k": (512, 16),
}


def _mesh_worker(rank, port, path):
    """One gloo rank: every arch of ``ARCHS`` on every mesh of ``MESHES``
    against the plain program (computed in each process)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_arch
    from repro_torch.dist.local_ops import is_dtensor
    from repro_torch.dist.sharding import (TRAIN_RULES, placements_for,
                                           set_rules)
    from repro_torch.launch import dryrun
    from repro_torch.models import layers as L
    from repro_torch.models.api import build_model, cache_map
    from repro_torch.tree import leaves, tree_map, unflatten

    torch.set_num_threads(1)
    dist.init_process_group("gloo", world_size=4, rank=rank,
                            init_method=f"tcp://localhost:{port}")
    calls = []
    dispatch = L.moe_dispatch

    def recording(xf, r, E, C, dtype):
        calls.append((r["stt"].clone(), r["slot"].clone(),
                      r["keep"].clone()))
        return dispatch(xf, r, E, C, dtype)

    L.moe_dispatch = recording

    def full(t):
        return (t.full_tensor() if is_dtensor(t) else t).detach()

    res = {}
    for arch in ARCHS:
        # capacity factor 1: the SMOKE routing drops pairs at every call;
        # no remat (it recomputes the same ops: the cells below trace it)
        cfg = dataclasses.replace(get_arch(arch).SMOKE,
                                  param_dtype="float64",
                                  compute_dtype="float64",
                                  capacity_factor=1.0, remat=False)
        m = build_model(cfg)
        rng = np.random.default_rng(0)
        plain = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab,
                                                        (B, S))),
                 "labels": torch.as_tensor(rng.integers(-1, cfg.vocab,
                                                        (B, S))),
                 "token": torch.as_tensor(rng.integers(0, cfg.vocab, (B,))),
                 "pos": torch.full((B,), S)}
        # every leaf float64, the float32 ones (router, A_log, D, dt_bias,
        # lam) too: a float32 gradient's partial sums would round apart
        params = tree_map(lambda t: t.double(), m.init(0, "cpu"))

        def train(params, bat):
            live = [p.detach().requires_grad_(True) for p in leaves(params)]
            with torch.enable_grad():
                loss = m.train_loss(unflatten(params, live),
                                    {"tokens": bat["tokens"],
                                     "labels": bat["labels"]})
                return [loss, *torch.autograd.grad(loss, live)]

        @torch.no_grad()
        def serve(params, cache, bat):
            lp, cache = m.prefill(params, {"tokens": bat["tokens"]}, cache)
            ld, cache = m.decode(params, {"token": bat["token"],
                                          "pos": bat["pos"]}, cache)
            return [lp, ld, *leaves(cache)]

        calls.clear()
        want = train(params, plain) + serve(
            params, m.init_cache(B, 2 * S, "cpu"), plain)
        want_calls = list(calls)
        for shape in MESHES:
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))

            def put(t, spec):
                if isinstance(t, dict):
                    return {k: put(v, spec[k]) for k, v in t.items()}
                return distribute_tensor(t, mesh, placements_for(spec, mesh))

            def placed(kind):
                """The params and the batch as the dry run's cell of
                ``kind`` places them, under its rules; the MoE under the
                train rules only: the dense dispatch (the serving rules
                route it through ``moe_a2a``)."""
                rules = TRAIN_RULES if cfg.family == "moe" else \
                    dryrun._cell_rules(cfg, kind, "baseline")
                plan = dryrun.plan_cell(cfg, kind, S, B, rules, mesh)
                dp = put(params, plan["params"][1])
                bat = {k: put(v, dryrun._input_spec(k, v, rules, mesh))
                       for k, v in plain.items()}
                return rules, dp, bat

            calls.clear()
            rules, dp, bat = placed("train")
            with set_rules(rules, mesh), implicit_replication():
                got = train(dp, bat)
            rules, dp, bat = placed("prefill")
            dc = cache_map(lambda t: put(t, dryrun._cache_spec(
                t, rules, mesh)), m.init_cache(B, 2 * S, "cpu"))
            with set_rules(rules, mesh), implicit_replication():
                got += serve(dp, dc, bat)
            # a float32 leaf (the recurrent states the cache keeps in
            # float32, as JAX's) within one float32 rounding
            worst = 0.0
            for a, b in zip(map(full, got), want):
                tol = 1e-9 if b.dtype == torch.float64 else 1e-6
                a, b = a.double(), b.double()
                scale = max(1.0, float(b.abs().max()))
                worst = max(worst, float(((a - b).abs() / (
                    tol * scale + tol * b.abs())).max()))
            kept, drops = len(calls) == len(want_calls), 0
            # this rank's tokens: its block of the data axis
            n, first = mesh.size(0), mesh.get_coordinate()[0]
            for (ws, wl, wk), (gs, gl, gk) in zip(want_calls, calls):
                tl = ws.numel() // cfg.top_k // n
                mine = ws // tl == first
                want_set = {(int(t) - first * tl, int(s)) for t, s in
                            zip(ws[wk & mine], wl[wk & mine])}
                got_set = {(int(t), int(s)) for t, s in zip(gs[gk], gl[gk])}
                kept = kept and got_set == want_set and \
                    int((~gk).sum()) == int((~wk & mine).sum())
                drops += int((~wk).sum())
            res[f"{arch}|{shape[0]}x{shape[1]}"] = dict(
                worst=worst, kept=kept, drops=drops, calls=len(calls))
    if rank == 0:
        with open(path, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def _mesh_main(path):
    import socket

    import torch.multiprocessing as mp
    with socket.socket() as s_:
        s_.bind(("localhost", 0))
        port = s_.getsockname()[1]
    mp.start_processes(_mesh_worker, args=(port, path), nprocs=4,
                       start_method="fork")


CELL = """
    import json
    from repro_torch.launch import dryrun
    arch, shape = {cell!r}.split("|")
    seq, batch = {cut!r}
    rec = dryrun.run_cell(arch, shape, "single", save=False, seq=seq,
                          batch=batch)
    print(json.dumps(rec))
"""

FLOPS = """
    import json, torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.models.api import build_model
    from repro_torch.train import make_train_step
    from repro_torch.train.step import TrainState
    arch = {arch!r}
    rec = dryrun.run_cell(arch, "train_4k", ((4, 1), ("data", "model")),
                          save=False, smoke=True, seq=32, batch=8)
    cfg = get_arch(arch).SMOKE
    m = build_model(cfg)
    opt = dryrun._optimizer(cfg)
    params = m.init(0, "cpu")
    state = TrainState(params=params, opt_state=opt.init(params),
                       step=torch.zeros((), dtype=torch.int32))
    batch = {{"tokens": torch.zeros(8, 32, dtype=torch.int32),
              "labels": torch.ones(8, 32, dtype=torch.int32)}}
    with FlopCounterMode(display=False) as fc:
        make_train_step(m, opt)(state, batch)
    print(json.dumps({{"rec": rec, "whole": fc.get_total_flops()}}))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess of this file at once. Returns name -> its JSON
    output."""
    tmp = tmp_path_factory.mktemp("dryrun_families")
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_NO_JAX_SHIM="1",
               OMP_NUM_THREADS="1")
    codes = {f"cell:{c}": CELL.format(cell=c, cut=cut)
             for c, cut in CUT_CELLS.items()}
    codes.update({f"flops:{a}": FLOPS.format(arch=a) for a in ARCHS})
    procs = {"mesh": subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "mesh",
         str(tmp / "mesh.json")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)}
    for name, code in codes.items():
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(code)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for name, p in procs.items():
        stdout, err = p.communicate(timeout=900)
        assert p.returncode == 0, (name, err[-4000:])
        if name == "mesh":
            with open(tmp / "mesh.json") as f:
                out[name] = json.load(f)
        else:
            out[name] = json.loads(stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("mesh", [f"{a}x{b}" for a, b in MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_per_rank_ops_compute_the_plain_program_on_a_real_mesh(runs, arch,
                                                               mesh):
    """Float64 SMOKE model (every leaf float64, so it computes in float64
    throughout, decode attention included), 4 gloo ranks: the train
    loss, every gradient, a prefill's logits, a decode's logits and
    every float64 cache leaf after it within rtol 1e-9 plus atol 1e-9 on
    the tensor's scale (its largest magnitude, at least 1), as
    ``test_torch_dryrun``'s dense case holds its float64 outputs; the
    recurrent states the cache keeps in float32 within 1e-6 and 1e-6
    (one float32 rounding). kimi: every dense dispatch (each
    layer of the train forward, the prefill and the decode) keeps on
    each rank the (token, slot) pairs that the plain dispatch keeps of
    that rank's tokens, and drops the others; the plain dispatch drops
    some pairs."""
    r = runs["mesh"][f"{arch}|{mesh}"]
    assert r["worst"] <= 1.0, r
    assert r["kept"], r
    if arch.startswith("kimi"):
        assert r["drops"] > 0, r


@pytest.mark.parametrize("cell", list(CUT_CELLS))
def test_full_width_cell_traces(runs, cell):
    """Full ``CONFIG``, the 16 x 16 mesh, no op left unplaced; the
    record names the cut (``seq``, ``batch``) it was traced at."""
    rec = runs[f"cell:{cell}"]
    assert rec["status"] == "ok", rec.get("error")
    assert (rec["seq"], rec["batch"]) == CUT_CELLS[cell]
    assert rec["chips"] == 256 and not rec["smoke"]
    assert rec["flops"] > 0
    assert sum(rec["collective_counts"].values()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_flops_per_device_times_devices_equal_the_whole(runs,
                                                                     arch):
    """A data-only mesh of 4 (each rank a quarter of the batch; a model
    axis would hold each token's router logits and the SSD's C x B
    products whole on every rank of it): the forward, the remat
    recompute and the backward of the train step."""
    out = runs[f"flops:{arch}"]
    rec = out["rec"]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == 4 and rec["flops"] > 0
    assert rec["flops"] * rec["chips"] == out["whole"]


if __name__ == "__main__":
    if sys.argv[1] == "mesh":
        _mesh_main(sys.argv[2])
