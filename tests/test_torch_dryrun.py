"""The port's LM dry run (``repro_torch.launch.dryrun``, the cost counter
``launch.costs``, the model-API helpers and the placeholder mesh)
against the JAX package's ``repro.launch.dryrun``.

* the API helpers ``shapes_and_logical``, ``input_specs`` and
  ``cache_specs`` equal JAX's for every arch at its full ``CONFIG`` and
  every ``SHAPES`` kind (names, shapes, dtypes, logical trees);
* per-device argument bytes (params, optimizer state, step, inputs,
  cache) of every arch x shape on the single and multi meshes equal the
  sum of ``NamedSharding(mesh, spec).shard_shape`` over JAX's leaves,
  computed in a subprocess with 512 placeholder devices (nothing
  compiled);
* a SMOKE dense cell's per-device FLOPs x devices equal
  ``FlopCounterMode`` of the same prefill on whole CPU tensors (a
  data-only mesh, the batch divides);
* the counter's collective counts and bytes on a hand-built DTensor
  program equal a count made by hand, and kimi-k2's SMOKE decode on an
  expert mesh counts the all-to-alls of ``moe_a2a``.

The fake process group of the dry run is global to a process, so every
run that starts one is a subprocess.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun as tdry
from repro_torch.launch.mesh import PRODUCTION_SHAPES, make_local_mesh
from repro_torch.models import api as tapi

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
KINDS = sorted({k for k, _, _ in tconfigs.SHAPES.values()})


def _env():
    return dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")


def _dtype(x):
    return str(x.dtype).replace("torch.", "")


def _flat_j_specs(specs):
    """(path, spec tuple) of a spec tree (tuples are leaves here)."""
    return [(jax.tree_util.keystr(p), v) for p, v in
            jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(x, tuple))[0]]


def _flat_j(tree):
    return [(jax.tree_util.keystr(p), v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _promoted(tcfg, path, jleaf, tleaf) -> bool:
    """The one dtype difference allowed: a layer matrix of a bfloat16
    config that the JAX init makes float32 (``1.0 / np.sqrt`` promotes
    it; ROADMAP Queue 3), where the port keeps ``param_dtype``."""
    from repro_torch.models.lm import FLOAT32_LEAVES
    return (str(jleaf.dtype) == "float32" and tleaf.dtype == tcfg.pdt ==
            torch.bfloat16 and tleaf.dim() >= 2 and
            path.split("'")[-2] not in FLOAT32_LEAVES)


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_api_helpers_match_jax(arch):
    jcfg = jconfigs.get_arch(arch).CONFIG
    tcfg = tconfigs.get_arch(arch).CONFIG
    jshapes, jlog = japi.shapes_and_logical(jcfg)
    tshapes, tlog = tapi.shapes_and_logical(tcfg)
    assert tlog == jlog
    js, ts = _flat_j(jshapes), _flat_j(tshapes)
    assert [p for p, _ in js] == [p for p, _ in ts]
    for (p, j), (_, t) in zip(js, ts):
        assert t.device.type == "meta"
        assert tuple(t.shape) == j.shape, p
        assert _dtype(t) == str(j.dtype) or _promoted(tcfg, p, j, t), p
    for kind in KINDS:
        for seq, batch in ((4096, 256), (32768, 1)):
            ji = japi.input_specs(jcfg, kind, seq, batch)
            ti = tapi.input_specs(tcfg, kind, seq, batch)
            assert list(ti) == list(ji)
            for k in ji:
                assert (tuple(ti[k].shape), _dtype(ti[k])) == \
                    (ji[k].shape, str(ji[k].dtype)), (kind, k)
    for batch, smax in ((128, 32768), (3, 40)):
        jc = jax.tree.leaves(japi.cache_specs(jcfg, batch, smax))
        tc = tapi.cache_leaves(tapi.cache_specs(tcfg, batch, smax))
        assert [(tuple(t.shape), _dtype(t)) for t in tc] == \
            [(c.shape, str(c.dtype)) for c in jc]


# --------------------------------------------------------------------------
# per-device argument bytes: the JAX side in a 512-device subprocess
# --------------------------------------------------------------------------

def _jax_shard_bytes(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import ARCH_IDS, SHAPES, get_arch
    from repro.dist.sharding import (MOE_SERVE_RULES, SERVE_RULES,
                                     TRAIN_RULES, param_partition_specs,
                                     spec_for)
    from repro.launch.dryrun import _opt_state_specs
    from repro.launch.mesh import make_production_mesh
    from repro.models.api import cache_specs, input_specs, \
        shapes_and_logical
    from repro.train import adafactor, adamw, cosine_schedule

    def nbytes(leaf, spec, mesh):
        shp = NamedSharding(mesh, spec).shard_shape(leaf.shape)
        return int(np.prod(shp)) * jnp.dtype(leaf.dtype).itemsize

    out = {}
    meshes = {m: make_production_mesh(multi_pod=m == "multi")
              for m in ("single", "multi")}
    for arch in ARCH_IDS:
        cfg = get_arch(arch).CONFIG
        pshapes, logical = shapes_and_logical(cfg)
        opt = adafactor(cosine_schedule(1e-4, 100, 10000)) \
            if cfg.family == "moe" else \
            adamw(cosine_schedule(3e-4, 100, 10000))
        ost = jax.eval_shape(opt.init, pshapes)
        for shape, (kind, seq, batch) in SHAPES.items():
            for mname, mesh in meshes.items():
                rules = TRAIN_RULES if kind == "train" else (
                    MOE_SERVE_RULES if cfg.family == "moe" else SERVE_RULES)
                pspecs = param_partition_specs(pshapes, logical, rules, mesh)
                specs_l = jax.tree.leaves(
                    pspecs, is_leaf=lambda x: isinstance(x, P))
                parts = {"params": {
                    jax.tree_util.keystr(p): [
                        int(np.prod(NamedSharding(mesh, s).shard_shape(
                            l.shape))), str(l.dtype)]
                    for (p, l), s in zip(
                        jax.tree_util.tree_flatten_with_path(pshapes)[0],
                        specs_l)}}
                ins = input_specs(cfg, kind, seq, batch)
                lg = {"tokens": ("batch", None), "labels": ("batch", None),
                      "frames": ("batch", "act_seq", None),
                      "token": ("batch",), "pos": ("batch",),
                      "enc_out": ("batch", None, None)}
                b = 0
                for k, v in ins.items():
                    if k == "positions":
                        g = (None, "batch", None) if len(v.shape) == 3 \
                            else ("batch", None)
                    else:
                        g = lg[k]
                    b += nbytes(v, spec_for(v.shape, g, rules, mesh), mesh)
                parts["batch"] = b
                if kind == "train":
                    osp = _opt_state_specs(ost, pshapes, pspecs)
                    parts["opt_state"] = sum(
                        nbytes(l, s, mesh) for l, s in zip(
                            jax.tree.leaves(ost), jax.tree.leaves(
                                osp, is_leaf=lambda x: isinstance(x, P))))
                    parts["step"] = 4
                else:
                    c = 0
                    for leaf in jax.tree.leaves(cache_specs(cfg, batch,
                                                            seq)):
                        n = len(leaf.shape)
                        if n >= 4:
                            g = [None] * n
                            g[-4], g[-3], g[-2] = "batch", "cache_seq", \
                                "kv_heads"
                            s = P(*spec_for(leaf.shape, g, rules, mesh))
                        else:
                            s = P()
                        c += nbytes(leaf, s, mesh)
                    parts["cache"] = c
                out[f"{arch}|{shape}|{mname}"] = parts
    with open(out_path, "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess of this file at once: the JAX shard bytes (512
    placeholder devices) and the port's fake-process-group runs
    (``TORCH_RUNS``). Returns name -> its JSON output."""
    tmp = tmp_path_factory.mktemp("dryrun_ref")
    jax_env = dict(_env(),
                   XLA_FLAGS="--xla_force_host_platform_device_count=512")
    torch_env = dict(_env(), REPRO_NO_JAX_SHIM="1")
    procs = {"bytes": subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "bytes",
         str(tmp / "bytes.json")], env=jax_env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)}
    for name, code in TORCH_RUNS.items():
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(code)], env=torch_env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for name, p in procs.items():
        stdout, err = p.communicate(timeout=900)
        assert p.returncode == 0, (name, err[-4000:])
        if name == "bytes":
            with open(tmp / "bytes.json") as f:
                out[name] = json.load(f)
        else:
            out[name] = json.loads(stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_argument_bytes_equal_jax_shard_shapes(runs, arch):
    """Every shape of the arch on both production meshes; the port's
    plan on a mesh description of the same axes (no process group).
    Optimizer state, step, inputs and cache: bytes equal. Params: each
    leaf's per-device elements equal; its bytes at the port's dtype,
    which is JAX's but for the promoted layer matrices (``_promoted``:
    the port's are bfloat16, half JAX's float32 bytes)."""
    cfg = tconfigs.get_arch(arch).CONFIG
    for shape, (kind, seq, batch) in tconfigs.SHAPES.items():
        for mname, (axes, sizes) in PRODUCTION_SHAPES.items():
            mesh = make_local_mesh("cpu", **dict(zip(axes, sizes)))
            rules = tdry._cell_rules(cfg, kind, "baseline")
            plan = tdry.plan_cell(cfg, kind, seq, batch, rules, mesh)
            got = tdry.argument_bytes(plan, mesh)
            want = dict(runs["bytes"][f"{arch}|{shape}|{mname}"])
            jparams = want.pop("params")
            tparams = dict(_flat_j(plan["params"][0]))
            specs = dict(_flat_j_specs(plan["params"][1]))
            assert set(tparams) == set(jparams)
            pbytes = promoted = 0
            for path, (elems, jdt) in jparams.items():
                t = tparams[path]
                n = int(np.prod(tdry.local_shape(t.shape, specs[path],
                                                 mesh)))
                assert n == elems, (arch, shape, mname, path)
                assert _dtype(t) == jdt or _promoted(
                    cfg, path, jnp.zeros((), jdt), t), path
                promoted += _dtype(t) != jdt
                pbytes += n * t.element_size()
            assert got.pop("params") == pbytes
            assert bool(promoted) == (cfg.param_dtype == "bfloat16")
            assert got == want, (arch, shape, mname)


# --------------------------------------------------------------------------
# traced cells and the counter: each in a process of its own
# --------------------------------------------------------------------------

TORCH_RUNS = {
    "flops": """
        import json, torch
        from torch.utils.flop_counter import FlopCounterMode
        from repro_torch.configs import get_arch
        from repro_torch.launch import dryrun
        from repro_torch.models.api import build_model
        rec = dryrun.run_cell("internlm2-1.8b", "prefill_32k",
                              ((4, 1), ("data", "model")), save=False,
                              smoke=True, seq=48, batch=8)
        cfg = get_arch("internlm2-1.8b").SMOKE
        m = build_model(cfg)
        with FlopCounterMode(display=False) as fc:
            m.prefill(m.init(0, "cpu"),
                      {"tokens": torch.zeros(8, 48, dtype=torch.int32)},
                      m.init_cache(8, 48, "cpu"))
        print(json.dumps({"rec": rec, "whole": fc.get_total_flops()}))
    """,
    "counter": """
        import json, torch
        import torch.distributed._functional_collectives as funcol
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)
        from repro_torch.launch import costs
        from repro_torch.launch.mesh import make_placeholder_mesh
        mesh = make_placeholder_mesh(shape=(4, 2), axes=("data", "model"))
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(8, 16), mesh,
                                   [Shard(0), Replicate()], run_check=False)
            p = DTensor.from_local(torch.empty(6, 10), mesh,
                                   [Replicate(), Partial()], run_check=False)
            u = torch.empty(12, 5, dtype=torch.bfloat16)
            with costs.CostCounter() as c:
                # all-gather over data: (32, 16) float32 on every rank
                x.redistribute(mesh, [Replicate(), Replicate()])
                # all-reduce over model: (6, 10) float32
                p.redistribute(mesh, [Replicate(), Replicate()])
                # one all-to-all of (12, 5) bf16 over the model group
                funcol.all_to_all_single(u, None, None,
                                         mesh.get_group("model"))
                y = torch.matmul(torch.empty(3, 4), torch.empty(4, 5))
        from repro_torch.dist.sharding import placements_for
        m3 = make_placeholder_mesh(shape=(2, 2, 2),
                                   axes=("pod", "data", "model"))
        rec = dict(c.record(), placements=[
            [type(p).__name__, getattr(p, "dim", None)]
            for p in placements_for((("pod", "data"), None, "model"), m3)])
        try:
            placements_for((("data", "pod"),), m3)
            rec["out_of_order"] = "accepted"
        except ValueError:
            rec["out_of_order"] = "refused"
        print(json.dumps(rec))
    """,
    "mesh": """
        import dataclasses, json, os, socket, tempfile
        import numpy as np
        import torch
        import torch.multiprocessing as mp

        def work(rank, port, path):
            import torch.distributed as dist
            from torch.distributed.device_mesh import init_device_mesh
            from torch.distributed.tensor import distribute_tensor
            from torch.distributed.tensor.experimental import \\
                implicit_replication
            from repro_torch.configs import get_arch
            from repro_torch.dist.local_ops import is_dtensor
            from repro_torch.dist.sharding import placements_for, set_rules
            from repro_torch.launch import dryrun
            from repro_torch.models.api import build_model, cache_map
            from repro_torch.tree import leaves
            dist.init_process_group("gloo", world_size=4, rank=rank,
                                    init_method=f"tcp://localhost:{port}")
            cfg = dataclasses.replace(get_arch("internlm2-1.8b").SMOKE,
                                      param_dtype="float64",
                                      compute_dtype="float64")
            m = build_model(cfg)
            rng = np.random.default_rng(0)
            B, S = 8, 32
            tok = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)))
            lab = torch.as_tensor(rng.integers(-1, cfg.vocab, (B, S)))
            nxt = torch.as_tensor(rng.integers(0, cfg.vocab, (B,)))
            params = m.init(0, "cpu")

            def step(params, cache, full):
                live = [p.detach().requires_grad_(True)
                        for p in leaves(params)]
                from repro_torch.tree import unflatten
                with torch.enable_grad():
                    loss = m.train_loss(unflatten(params, live),
                                        {"tokens": tok_, "labels": lab_})
                    g = torch.autograd.grad(loss, live)
                with torch.no_grad():
                    lp, cache = m.prefill(params, {"tokens": tok_}, cache)
                    ld, cache = m.decode(params, {"token": nxt_,
                                                  "pos": pos_}, cache)
                outs = [loss, *g, lp, ld, *leaves(cache)]
                return [full(t).detach().double() for t in outs]

            tok_, lab_, nxt_ = tok, lab, nxt
            pos_ = torch.full((B,), S)
            want = step(params, m.init_cache(B, 2 * S, "cpu"), lambda t: t)
            res = {}
            for shape in ((2, 2), (1, 4)):
                mesh = init_device_mesh("cpu", shape,
                                        mesh_dim_names=("data", "model"))
                worst = 0.0
                for kind in ("train", "decode"):
                    rules = dryrun._cell_rules(cfg, kind, "baseline")
                    plan = dryrun.plan_cell(cfg, kind, S, B, rules, mesh)

                    def put(t, spec):
                        return distribute_tensor(t, mesh,
                                                 placements_for(spec, mesh))

                    def put_tree(t, spec):
                        if isinstance(t, dict):
                            return {k: put_tree(v, spec[k])
                                    for k, v in t.items()}
                        return put(t, spec)
                    dp = put_tree(params, plan["params"][1])
                    cache = m.init_cache(B, 2 * S, "cpu")
                    dc = cache_map(lambda t: put(t, dryrun._cache_spec(
                        t, rules, mesh)), cache)
                    bat = {k: put(v, dryrun._input_spec(k, v, rules, mesh))
                           for k, v in (("tokens", tok), ("labels", lab),
                                        ("token", nxt))}
                    tok_, lab_, nxt_ = bat["tokens"], bat["labels"], \\
                        bat["token"]
                    pos_ = put(torch.full((B,), S),
                               dryrun._input_spec("pos", nxt, rules, mesh))
                    with set_rules(rules, mesh), implicit_replication():
                        got = step(dp, dc, lambda t: t.full_tensor()
                                   if is_dtensor(t) else t)
                    # |a - b| over (atol x scale + rtol |b|); the decode
                    # step's attention is float32 (as JAX's), so its
                    # logits and the cache after it are held at float32's
                    ng = len(leaves(params))
                    for i, (a, b) in enumerate(zip(got, want)):
                        tol = 1e-9 if i < ng + 2 else 1e-5
                        scale = max(1.0, float(b.abs().max()))
                        worst = max(worst, float(((a - b).abs() / (
                            tol * scale + tol * b.abs())).max()))
                res["x".join(map(str, shape))] = worst
            if rank == 0:
                with open(path, "w") as f:
                    json.dump(res, f)
            dist.destroy_process_group()

        with socket.socket() as s_:
            s_.bind(("localhost", 0))
            port = s_.getsockname()[1]
        path = os.path.join(tempfile.mkdtemp(), "mesh.json")
        mp.start_processes(work, args=(port, path), nprocs=4,
                           start_method="fork")
        with open(path) as f:
            print(json.dumps(json.load(f)))
    """,
    "kimi": """
        import json
        from repro_torch.launch import dryrun
        rec = dryrun.run_cell("kimi-k2-1t-a32b", "decode_32k",
                              ((2, 2, 2), ("pod", "data", "model")),
                              save=False, smoke=True, seq=64, batch=8)
        print(json.dumps(rec))
    """,
}


def test_smoke_flops_per_device_times_devices_equal_the_whole(runs):
    rec = runs["flops"]["rec"]
    assert rec["status"] == "ok", rec
    assert rec["chips"] == 4
    assert rec["flops"] > 0
    assert rec["flops"] * rec["chips"] == runs["flops"]["whole"]
    assert rec["memory"]["argument_size_in_bytes"] == \
        sum(rec["argument_bytes"].values())


def test_counter_counts_a_hand_built_program(runs):
    """The counter against a count by hand; ``placements_for`` on the
    same fake process group."""
    out = runs["counter"]
    assert out["collective_counts"] == {
        "all-reduce": 1, "all-gather": 1, "reduce-scatter": 0,
        "all-to-all": 1, "collective-permute": 0}
    assert out["collective_bytes"]["all-gather"] == 32 * 16 * 4
    assert out["collective_bytes"]["all-reduce"] == 6 * 10 * 4
    assert out["collective_bytes"]["all-to-all"] == 12 * 5 * 2
    assert out["collective_elements"]["all-to-all"] == 60
    assert out["flops"] == 2 * 3 * 4 * 5
    # the matmul's inputs and output: (12 + 20 + 15) float32
    assert out["bytes_accessed"] >= 47 * 4
    # one tensor dim over (pod, data), pod outermost, as a PartitionSpec;
    # the other order would split otherwise, so it is refused
    assert out["placements"] == [["Shard", 0], ["Shard", 0], ["Shard", 2]]
    assert out["out_of_order"] == "refused"


def test_the_dry_runs_program_computes_the_plain_one_on_a_real_mesh(runs):
    """The program the dry run traces (``dist.local_ops``: head splits,
    attention per rank, cache row writes, the vocabulary-parallel
    embedding and loss, gradients on their parameters' shards) run on
    real DTensors over 4 gloo ranks, on a 2 x 2 and a 1 x 4 (data,
    model) mesh (KV heads split, and KV heads whole with each rank
    slicing its own): internlm2-1.8b SMOKE in float64, its train loss,
    every gradient and a prefill's logits equal the plain single-process
    program's within rtol 1e-9 plus atol 1e-9 on the tensor's scale (its
    largest magnitude, at least 1); a decode's logits and every cache
    leaf after it within 1e-5 and 1e-5 (the decode attention computes in
    float32, as JAX's does). Float64, as float32's own rounding (1.7e-4
    of the embed gradient's scale against float64) would hide a
    fault."""
    out = runs["mesh"]
    assert set(out) == {"2x2", "1x4"}
    for mesh, worst in out.items():
        assert worst <= 1.0, (mesh, worst)


def test_kimi_smoke_decode_counts_the_a2a_dispatch(runs):
    """On a 2 x 2 x 2 mesh the experts (8) split over (pod, data): per
    layer one all-to-all an expert axis each way, each moving the
    (E, C_l, d) buffer: C_l = ceil(2 tokens x 2 / 8 x 1.25) = 1."""
    rec = runs["kimi"]
    assert rec["status"] == "ok", rec
    cfg = tconfigs.get_arch("kimi-k2-1t-a32b").SMOKE
    per_layer = 4
    assert rec["collective_counts"]["all-to-all"] == per_layer * cfg.layers
    assert rec["collective_bytes"]["all-to-all"] == \
        per_layer * cfg.layers * cfg.n_experts * 1 * cfg.d_model * 4


if __name__ == "__main__":
    if sys.argv[1] == "bytes":
        _jax_shard_bytes(sys.argv[2])
