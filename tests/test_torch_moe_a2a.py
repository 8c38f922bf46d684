"""The port's all-to-all MoE dispatch (``repro_torch.models.moe_a2a``) on
a stacked local mesh against the JAX package's ``moe_ffn_a2a`` under
``shard_map`` on 4 placeholder devices (the JAX side runs once, in a
subprocess: this file as a script).

Same inputs from a numpy seed. Checks: each shard's top-k experts equal
JAX's ``lax.top_k`` on that shard's tokens, the kept pairs equal a host
count of the per-shard capacity rule, outputs and aux loss within
float32 tolerance (rtol 1e-5, atol 1e-5 of the output's scale) or the
bfloat16 one (rtol / atol 2e-2, ``tests/test_torch_models.py``'s
``BF16_TOL``); ``lm.moe_apply`` takes the all-to-all exactly where JAX's
does; a kimi-k2 SMOKE prefill and decode under ``MOE_SERVE_RULES`` on a
4-wide expert mesh equal JAX's.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

# name -> (mesh sizes, mesh axes, token axes, expert axes, tp axis, B, S,
#          E, top_k, capacity factor, dtype)
CASES = {
    "ep4": ((4,), ("data",), ("data",), ("data",), None, 8, 3, 8, 2, 1.25,
            "float32"),
    "ep2_tp2": ((2, 2), ("data", "model"), ("data",), ("data",), "model",
                4, 5, 6, 2, 1.25, "float32"),
    "tok_other_axis": ((2, 2), ("data", "model"), ("model",), ("data",),
                       None, 6, 4, 4, 2, 1.25, "float32"),
    "drops": ((4,), ("data",), ("data",), ("data",), None, 8, 6, 8, 2, 0.5,
              "float32"),
    "ep4_bf16": ((4,), ("data",), ("data",), ("data",), None, 8, 3, 8, 2,
                 1.25, "bfloat16"),
    "ep2_tp2_bf16": ((2, 2), ("data", "model"), ("data",), ("data",),
                     "model", 4, 5, 6, 2, 0.5, "bfloat16"),
    # fallbacks to the dense dispatch
    "one_expert_shard": ((4,), ("data",), ("data",), (), None, 4, 3, 8, 2,
                         1.25, "float32"),
    "experts_not_divisible": ((4,), ("data",), ("data",), ("data",), None,
                              8, 3, 6, 2, 1.25, "float32"),
    "batch_not_divisible": ((4,), ("data",), ("data",), ("data",), None, 6,
                            3, 8, 2, 1.25, "float32"),
}
D_MODEL, D_FF = 16, 12
# moe_apply under each context: (rules name or None, mesh sizes, axes)
APPLY_CASES = {
    "none": (None, None, None),
    "serve_rules": ("SERVE_RULES", (4,), ("data",)),
    "moe_serve": ("MOE_SERVE_RULES", (4,), ("data",)),
    "moe_serve_2x2": ("MOE_SERVE_RULES", (2, 2), ("data", "model")),
    "train_rules": ("TRAIN_RULES", (4,), ("data",)),
    "moe_serve_no_mesh": ("MOE_SERVE_RULES", None, None),
}
KIMI_B, KIMI_S, KIMI_STEPS = 4, 7, 2


def _inputs(name):
    _, _, _, _, _, B, S, E, _, _, _ = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    x = rng.normal(size=(B, S, D_MODEL)).astype(np.float32)
    router = rng.normal(size=(D_MODEL, E)).astype(np.float32)
    w1, w3 = (rng.normal(size=(E, D_MODEL, D_FF)).astype(np.float32) / 4
              for _ in range(2))
    w2 = rng.normal(size=(E, D_FF, D_MODEL)).astype(np.float32) / 4
    return x, router, w1, w3, w2


def _kimi_tokens(vocab):
    rng = np.random.default_rng(5)
    return rng.integers(0, vocab, (KIMI_B, KIMI_S)).astype(np.int32)


# --------------------------------------------------------------------------
# the JAX reference (run as a script in a subprocess)
# --------------------------------------------------------------------------

def _reference(out_path):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro import configs as jconfigs
    from repro.dist import sharding as jsh
    from repro.models import api as japi
    from repro.models import lm as jlm
    from repro.models import moe_a2a as jmoe

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _lm_cases import numpy_params
    from repro_torch import configs as tconfigs

    def mesh_of(sizes, axes):
        n = int(np.prod(sizes))
        return jax.make_mesh(sizes, axes, devices=jax.devices()[:n],
                             axis_types=(AxisType.Auto,) * len(axes))

    out = {}
    for name, (sizes, axes, tok, exp, tp, B, S, E, k, cf, dt) in \
            CASES.items():
        x, router, w1, w3, w2 = _inputs(name)
        dtype = jnp.dtype(dt)
        mesh = mesh_of(sizes, axes)
        fn = jax.jit(lambda *a: jmoe.moe_ffn_a2a(
            *a, top_k=k, capacity_factor=cf, dtype=dtype, mesh=mesh,
            token_axes=tok, expert_axes=exp, tp_axis=tp))
        y, aux = fn(jnp.asarray(x).astype(dtype), jnp.asarray(router),
                    *(jnp.asarray(w).astype(dtype) for w in (w1, w3, w2)))
        out[f"{name}/y"] = np.asarray(y.astype(jnp.float32))
        out[f"{name}/aux"] = np.asarray(aux)
        # each token shard's top-k, JAX's own lax.top_k on its tokens
        n_tok = int(np.prod([dict(zip(axes, sizes))[a] for a in tok]))
        if B % n_tok:
            continue
        xs = jnp.asarray(x).astype(dtype).reshape(n_tok, -1, D_MODEL)
        logits = xs.astype(jnp.float32) @ jnp.asarray(router)
        out[f"{name}/gidx"] = np.asarray(jax.lax.top_k(logits, k)[1])

    kimi = jconfigs.get_arch("kimi-k2-1t-a32b").SMOKE
    tcfg = tconfigs.get_arch("kimi-k2-1t-a32b").SMOKE
    jp, _ = numpy_params(tcfg, seed=3)
    lp = jax.tree.map(lambda a: a[0], jp["layers"])
    hx = np.random.default_rng(9).normal(
        size=(4, 3, kimi.d_model)).astype(np.float32)
    calls = []
    real = jmoe.moe_ffn_a2a

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    jmoe.moe_ffn_a2a = spy
    for name, (rules, sizes, axes) in APPLY_CASES.items():
        calls.clear()
        mesh = mesh_of(sizes, axes) if sizes else None
        ctx = jsh.set_rules(getattr(jsh, rules), mesh) if rules else None
        if ctx:
            with ctx:
                y, aux = jax.jit(lambda p, h: jlm.moe_apply(kimi, p, h))(
                    lp, jnp.asarray(hx))
        else:
            y, aux = jax.jit(lambda p, h: jlm.moe_apply(kimi, p, h))(
                lp, jnp.asarray(hx))
        out[f"apply/{name}/y"] = np.asarray(y)
        out[f"apply/{name}/aux"] = np.asarray(aux)
        out[f"apply/{name}/a2a"] = np.asarray(bool(calls))
    jmoe.moe_ffn_a2a = real

    model = japi.build_model(kimi)
    toks = _kimi_tokens(kimi.vocab)
    mesh = mesh_of((4,), ("data",))
    with jsh.set_rules(jsh.MOE_SERVE_RULES, mesh):
        cache = japi._cache_struct(kimi, KIMI_B, 16)
        logits, cache = jax.jit(model.prefill)(
            jp, {"tokens": jnp.asarray(toks)}, cache)
        out["kimi/prefill"] = np.asarray(logits)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        for i in range(KIMI_STEPS):
            pos = jnp.full((KIMI_B,), KIMI_S + i, jnp.int32)
            logits, cache = jax.jit(model.decode)(
                jp, {"token": tok, "pos": pos}, cache)
            out[f"kimi/decode{i}"] = np.asarray(logits)
            out[f"kimi/token{i}"] = np.asarray(tok)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("moe_a2a_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          str(path)], env=env, capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(path) as z:
        return dict(z)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(port, want, tol, what=""):
    port = port.float().numpy() if torch.is_tensor(port) else port
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(port, want, rtol=tol["rtol"],
                               atol=tol["atol"] * scale, err_msg=what)


def _host_kept(gidx, E, C):
    """Kept pairs of one shard by the capacity rule: expert e serves its
    first C pairs in (token, choice) order."""
    seen = np.zeros(E, int)
    kept = 0
    for row in gidx:
        for e in row:
            kept += seen[e] < C
            seen[e] += 1
    return kept


@pytest.mark.parametrize("name", list(CASES))
def test_moe_ffn_a2a_matches_jax(ref, name):
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe_a2a

    sizes, axes, tok, exp, tp, B, S, E, k, cf, dt = CASES[name]
    dtype = getattr(torch, dt)
    mesh = make_local_mesh("cpu", **dict(zip(axes, sizes)))
    x, router, w1, w3, w2 = (torch.from_numpy(a) for a in _inputs(name))
    y, aux, r = moe_a2a.moe_ffn_a2a(
        x.to(dtype), router, w1.to(dtype), w3.to(dtype), w2.to(dtype),
        top_k=k, capacity_factor=cf, dtype=dtype, mesh=mesh,
        token_axes=tok, expert_axes=exp, tp_axis=tp, return_routing=True)
    tol = F32_TOL if dt == "float32" else BF16_TOL
    close(y, ref[f"{name}/y"], tol, "output")
    close(aux, ref[f"{name}/aux"], F32_TOL, "aux loss")
    plan = moe_a2a.a2a_plan(B, S, E, D_FF, top_k=k, capacity_factor=cf,
                            mesh=mesh, token_axes=tok, expert_axes=exp,
                            tp_axis=tp)
    if plan is None:
        assert r is None and name.startswith(("one_", "experts_", "batch_"))
        return
    assert not name.startswith(("one_", "experts_", "batch_"))
    # every device's routing of its token shard (devices row-major)
    sz = dict(zip(axes, sizes))
    grid = r["gidx"].reshape(tuple(sizes) + r["gidx"].shape[1:])
    jg = ref[f"{name}/gidx"]
    kept = r["keep"].sum(-1).reshape(sizes)
    for dev in np.ndindex(*sizes):
        at = dict(zip(axes, dev))
        t = 0
        for a in tok:
            t = t * sz[a] + at[a]
        np.testing.assert_array_equal(grid[dev].numpy(), jg[t])
        assert int(kept[dev]) == _host_kept(jg[t], E, plan["C_l"])
    if name == "drops":
        assert int(kept.sum()) < B * S * k


@pytest.mark.parametrize("name", list(APPLY_CASES))
def test_moe_apply_takes_a2a_where_jax_does(ref, name, monkeypatch):
    from repro_torch import configs as tconfigs
    from repro_torch.dist import sharding as tsh
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm as tlm
    from repro_torch.models import moe_a2a

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _lm_cases import numpy_params
    tcfg = tconfigs.get_arch("kimi-k2-1t-a32b").SMOKE
    _, tp = numpy_params(tcfg, seed=3)
    lp = {k: v[0] for k, v in tp["layers"].items()}
    hx = torch.from_numpy(np.random.default_rng(9).normal(
        size=(4, 3, tcfg.d_model)).astype(np.float32))
    calls = []
    real = moe_a2a.moe_ffn_a2a
    monkeypatch.setattr(moe_a2a, "moe_ffn_a2a",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    rules, sizes, axes = APPLY_CASES[name]
    if rules:
        mesh = (make_local_mesh("cpu", **dict(zip(axes, sizes)))
                if sizes else None)
        with tsh.set_rules(getattr(tsh, rules), mesh):
            y, aux = tlm.moe_apply(tcfg, lp, hx)
    else:
        y, aux = tlm.moe_apply(tcfg, lp, hx)
    assert bool(calls) == bool(ref[f"apply/{name}/a2a"])
    close(y, ref[f"apply/{name}/y"], F32_TOL, "moe_apply output")
    close(aux, ref[f"apply/{name}/aux"], F32_TOL, "aux loss")


def test_kimi_smoke_serves_on_an_expert_mesh_as_jax(ref):
    """Prefill (batch 4 on the 4-wide expert mesh: per-shard capacity)
    and two decode steps of kimi-k2's SMOKE model under
    ``MOE_SERVE_RULES``; logits equal JAX's, which differ from the
    dense dispatch's (other capacities)."""
    from repro_torch import configs as tconfigs
    from repro_torch.dist import sharding as tsh
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import api as tapi

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _lm_cases import numpy_params
    tcfg = tconfigs.get_arch("kimi-k2-1t-a32b").SMOKE
    _, tp = numpy_params(tcfg, seed=3)
    model = tapi.build_model(tcfg)
    toks = torch.from_numpy(_kimi_tokens(tcfg.vocab))
    mesh = make_local_mesh("cpu", data=4)
    with tsh.set_rules(tsh.MOE_SERVE_RULES, mesh):
        cache = model.init_cache(KIMI_B, 16, "cpu")
        logits, cache = model.prefill(tp, {"tokens": toks}, cache)
        close(logits, ref["kimi/prefill"], F32_TOL, "prefill logits")
        for i in range(KIMI_STEPS):
            tok = torch.from_numpy(ref[f"kimi/token{i}"])
            pos = torch.full((KIMI_B,), KIMI_S + i, dtype=torch.int32)
            logits, cache = model.decode(tp, {"token": tok, "pos": pos},
                                         cache)
            close(logits, ref[f"kimi/decode{i}"], F32_TOL, f"decode {i}")
    dense, _ = model.prefill(tp, {"tokens": toks},
                             model.init_cache(KIMI_B, 16, "cpu"))
    assert not np.allclose(dense.numpy(), ref["kimi/prefill"], atol=1e-4)


if __name__ == "__main__":
    _reference(sys.argv[1])
