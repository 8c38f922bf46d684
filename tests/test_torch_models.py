"""The port's LM models (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package's (``repro.models``, ``repro.configs``) on the
CPU: the same inputs, made with numpy from a seed, and the same params
(the JAX init carried across with ``convert.lm_params_from_numpy``).

Layers, and for every ``dense`` / ``vlm`` SMOKE arch (plus a windowed
one, for the ring cache) the train-mode forward, the prefill logits and
every cache leaf, and 3 decode steps, within 1e-5 in float32 (rtol and
atol, ``atol`` on each tensor's scale: ``close``); one arch in bfloat16
at rtol 2e-2 (the JAX suite's ``test_prefill_decode_matches_forward``)
and atol 2e-2 of the scale (``BF16_TOL``). For all ten archs: configs
field for field, parameter counts (total and MoE-active), the init's
shapes, dtypes and logical specs, and cache shapes. The other families'
models: ``tests/test_torch_lm_families.py``.
"""
import contextlib
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import layers as JL
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.models import api as tapi
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm

from _lm_cases import jax_params

F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bfloat16: the JAX suite's rtol 2e-2; atol 2e-2 of the tensor's scale, not
# 2e-3: 2e-3 of a logit scale of 3-4 is under one bfloat16 ulp there
# (0.0156), and a float32 op that lands on the other side of a bfloat16
# rounding boundary in one package moves a logit by 1-2 such ulps
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
DENSE = [a for a in tconfigs.ARCH_IDS
         if tconfigs.get_arch(a).CONFIG.family in ("dense", "vlm")]
# the dense / vlm SMOKE configs, plus a windowed one (the ring cache)
SMOKES = [(a, None) for a in DENSE] + [("internlm2-1.8b", 8)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tensors here are small: one intra-op thread keeps torch's pool
    from spinning against the JAX side and the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(port, ref, tol=F32_TOL, what=""):
    """``port`` within ``rtol`` of ``ref`` elementwise, plus ``atol`` on
    the tensor's scale (its largest magnitude, at least 1): the random
    init's activations reach hundreds and its attention is near one-hot,
    so a value that cancels to near 0 keeps the absolute error of its
    inputs."""
    port = port.float().numpy() if torch.is_tensor(port) else port
    ref = np.asarray(ref, np.float32)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(port, ref, rtol=tol["rtol"],
                               atol=tol["atol"] * scale, err_msg=what)


def configs(arch, window=None):
    jcfg = jconfigs.get_arch(arch).SMOKE
    tcfg = tconfigs.get_arch(arch).SMOKE
    if window is not None:
        jcfg, tcfg = jcfg.scaled(window=window), tcfg.scaled(window=window)
    return jcfg, tcfg


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_and_rope(rng):
    x = rng.normal(size=(2, 11, 3, 16)).astype(np.float32) * 3
    g = rng.normal(size=(16,)).astype(np.float32)
    close(TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(g)),
          JL.rmsnorm(jnp.asarray(x), jnp.asarray(g)))
    pos = rng.integers(0, 4000, (2, 11)).astype(np.int32)
    close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
          JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    pos3 = rng.integers(0, 300, (3, 2, 11)).astype(np.int32)
    close(TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e4,
                         (2, 3, 3)),
          JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e4, (2, 3, 3)))


def test_rmsnorm_and_rope_bf16(rng):
    """bfloat16 products in the JAX order (rmsnorm: x * r * g; RoPE:
    promoted to float32, cast back)."""
    x = (rng.normal(size=(2, 7, 2, 16)) * 5).astype(np.float32)
    g = rng.normal(size=(16,)).astype(np.float32)
    xt = torch.from_numpy(x).bfloat16()
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    gt, gj = torch.from_numpy(g).bfloat16(), jnp.asarray(g, jnp.bfloat16)
    a, b = TL.rmsnorm(xt, gt), JL.rmsnorm(xj, gj)
    assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
    np.testing.assert_array_equal(a.float().numpy(),
                                  np.asarray(b.astype(jnp.float32)))
    pos = rng.integers(0, 512, (2, 7)).astype(np.int32)
    a = TL.apply_rope(xt, torch.from_numpy(pos), 1e6)
    b = JL.apply_rope(xj, jnp.asarray(pos), 1e6)
    assert a.dtype == torch.bfloat16
    close(a, b.astype(jnp.float32), BF16_TOL)


@pytest.mark.parametrize("case", [
    # (B, Sq, Skv, Hq, Hkv, causal, window, q_chunk, kv_chunk, q_offset)
    (2, 16, 16, 4, 4, True, None, 512, 1024, 0),     # one block, MHA
    (2, 21, 21, 4, 2, True, None, 8, 6, 0),          # ragged chunks, GQA
    (1, 19, 19, 6, 2, True, 5, 4, 8, 0),             # windowed, G = 3
    (2, 9, 9, 4, 1, False, None, 4, 4, 0),           # bidirectional
    (2, 7, 20, 4, 2, True, None, 3, 6, 13),          # q_offset continuation
    (1, 11, 23, 8, 2, True, 6, 5, 7, 12),            # all of it
])
def test_flash_attention(rng, case):
    B, Sq, Skv, Hq, Hkv, causal, window, qc, kc, off = case
    q = rng.normal(size=(B, Sq, Hq, 16)).astype(np.float32)
    k = rng.normal(size=(B, Skv, Hkv, 16)).astype(np.float32)
    v = rng.normal(size=(B, Skv, Hkv, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_chunk=qc, kv_chunk=kc,
              q_offset=off)
    close(TL.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw),
          JL.flash_attention(*map(jnp.asarray, (q, k, v)), **kw))


@pytest.mark.parametrize("window", [None, 4])
def test_decode_attention(rng, window):
    B, Smax, Hq, Hkv = 3, 12, 6, 2
    q = rng.normal(size=(B, 1, Hq, 16)).astype(np.float32)
    kc = rng.normal(size=(B, Smax, Hkv, 16)).astype(np.float32)
    vc = rng.normal(size=(B, Smax, Hkv, 16)).astype(np.float32)
    clen = np.array([1, 7, 12], np.int32)
    close(TL.decode_attention(*map(torch.from_numpy, (q, kc, vc, clen)),
                              window=window),
          JL.decode_attention(*map(jnp.asarray, (q, kc, vc, clen)),
                              window=window))


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def run_both(jcfg, tcfg, jp, tp, toks, steps=3, smax=32, tol=F32_TOL,
             frames=None):
    """Train-mode forward, prefill (logits and every cache leaf) and
    ``steps`` decode steps (logits and every cache leaf) of both packages
    on the same tokens (``encdec``: and the same ``frames``, encoded by
    each package, the decode fed each package's ``enc_out``). The JAX side
    is jitted in float32 and runs op by op in bfloat16 (see
    ``test_model_matches_jax_bf16``)."""
    with contextlib.ExitStack() as stack:
        if tcfg.cdt == torch.bfloat16:
            stack.enter_context(jax.disable_jit())
        _run_both(jcfg, tcfg, jp, tp, toks, steps, smax, tol, frames)


def _run_both(jcfg, tcfg, jp, tp, toks, steps, smax, tol, frames):
    B, S = toks.shape
    jm, tm = japi.build_model(jcfg), tapi.build_model(tcfg)
    jit = jax.jit if tcfg.cdt == torch.float32 else (lambda f: f)
    tt = torch.from_numpy(toks)
    jb, tb, jenc, tenc = {}, {}, None, None
    if frames is not None:
        jb["frames"], tb["frames"] = jnp.asarray(frames), \
            torch.from_numpy(frames)
        jenc = jit(lambda p, f: jlm.encode(jcfg, p, f))(jp, jb["frames"])
        tenc = tlm.encode(tcfg, tp, tb["frames"])
        close(tenc, jenc, tol, "encoder states")

    def jtrain(p, t, e):
        h, _, aux = jlm.forward(jcfg, p, t, jlm.make_positions(jcfg, t),
                                "train", enc_out=e)
        return jlm._unembed(jcfg, p, h), aux
    jlogits, jaux = jit(jtrain)(jp, jnp.asarray(toks), jenc)
    th, _, taux = tlm.forward(tcfg, tp, tt, tlm.make_positions(tcfg, tt),
                              "train", enc_out=tenc)
    close(tlm._unembed(tcfg, tp, th), jlogits, tol, "train-mode logits")
    close(taux, jaux, tol, "aux loss")
    jprefill, jdecode = jit(jm.prefill), jit(jm.decode)
    jc = jm.init_cache(B, smax)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks), **jb}, jc)
    tc = tm.init_cache(B, smax, device="cpu")
    tl, tc = tm.prefill(tp, {"tokens": tt, **tb}, tc)
    close(tl, jl, tol, "prefill logits")
    check_cache(tc, jc, tol, "prefill")
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for s in range(steps):
        pos = np.full((B,), S + s, np.int32)
        jd = {"token": jnp.asarray(nxt), "pos": jnp.asarray(pos)}
        td = {"token": torch.from_numpy(nxt), "pos": torch.from_numpy(pos)}
        if frames is not None:
            jd["enc_out"], td["enc_out"] = jenc, tenc
        jl, jc = jdecode(jp, jd, jc)
        tl, tc = tm.decode(tp, td, tc)
        close(tl, jl, tol, f"decode {s} logits")
        check_cache(tc, jc, tol, f"decode {s}")
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def check_cache(tc, jc, tol, what):
    """Every leaf of the port's cache tree against the JAX one's: shape,
    dtype and values."""
    tl, jl = tapi.cache_leaves(tc), jax.tree.leaves(jc)
    assert len(tl) == len(jl), what
    for i, (a, b) in enumerate(zip(tl, jl)):
        assert tuple(a.shape) == b.shape, (what, i)
        assert str(a.dtype).split(".")[1] == str(b.dtype), (what, i)
        close(a, b.astype(jnp.float32), tol, f"{what} cache leaf {i}")


@pytest.mark.parametrize("arch,window", SMOKES)
def test_model_matches_jax(arch, window, rng):
    jcfg, tcfg = configs(arch, window)
    jp, tp = jax_params(jcfg)
    toks = rng.integers(0, tcfg.vocab, (2, 13)).astype(np.int32)
    run_both(jcfg, tcfg, jp, tp, toks)


@pytest.mark.parametrize("all_bf16", [False, True])
def test_model_matches_jax_bf16(all_bf16, rng):
    """internlm2 SMOKE in bfloat16. The JAX init leaves the default-scale
    matrices float32 (its ``1 / np.sqrt`` scale promotes them): that tree
    runs mixed (float32 products). The port's init makes every leaf
    bfloat16, the dtype the card serves in: both packages on that tree
    (``all_bf16``). The JAX side runs op by op (``jax.disable_jit``, in
    ``run_both``): jitted, XLA fuses a layer's bfloat16 elementwise ops
    and rounds once where each op rounds op by op, and the package's own
    jitted and op-by-op logits then differ by 0.5-1.4% of their scale
    (over 4 token draws), more than atol 2e-3 of it."""
    jcfg, tcfg = configs("internlm2-1.8b")
    kw = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg, tcfg = jcfg.scaled(**kw), tcfg.scaled(**kw)
    jp, tp = jax_params(jcfg, seed=2)
    if all_bf16:
        jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
        tp = {k: {n: t.bfloat16() for n, t in v.items()}
              if isinstance(v, dict) else v.bfloat16()
              for k, v in tp.items()}
    toks = rng.integers(0, tcfg.vocab, (2, 10)).astype(np.int32)
    run_both(jcfg, tcfg, jp, tp, toks, steps=2, tol=BF16_TOL)


def test_params_round_trip_bf16():
    jcfg = jconfigs.get_arch("qwen2.5-3b").SMOKE.scaled(
        param_dtype="bfloat16")
    jp = jax.tree.map(np.asarray, japi.build_model(jcfg).init(
        jax.random.PRNGKey(0)))
    back = lm_params_to_numpy(lm_params_from_numpy(jp, "cpu"))
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_port_init_shapes_specs_and_dtypes():
    """The port's own init, every arch's SMOKE in float32 and in bfloat16:
    every leaf of the JAX init's shape, in the config's param dtype but
    the leaves the JAX init makes float32 whatever the config says
    (router, A_log, D, dt_bias, lam), and the same logical specs; the
    same generator gives the same tree."""
    for arch, dtype in itertools.product(tconfigs.ARCH_IDS,
                                         ("float32", "bfloat16")):
        jcfg, tcfg = configs(arch)
        jcfg, tcfg = jcfg.scaled(param_dtype=dtype), \
            tcfg.scaled(param_dtype=dtype)
        jm, tm = japi.build_model(jcfg), tapi.build_model(tcfg)
        tp = tm.init(0, device="cpu")
        jshapes = japi.shapes_and_logical(jcfg)[0]
        flat_j = jax.tree_util.tree_flatten_with_path(jshapes)[0]
        flat_t = {jax.tree_util.keystr(p): v for p, v in
                  jax.tree_util.tree_flatten_with_path(tp)[0]}
        assert len(flat_j) == len(flat_t)
        for path, leaf in flat_j:
            t = flat_t[jax.tree_util.keystr(path)]
            assert tuple(t.shape) == leaf.shape, (arch, path)
            f32 = path[-1].key in tlm.FLOAT32_LEAVES
            assert t.dtype == (torch.float32 if f32 else tcfg.pdt), \
                (arch, path)
            if f32:
                assert leaf.dtype == jnp.float32, (arch, path)
        assert tm.logical_specs == jm.logical_specs
        again = tm.init(torch.Generator().manual_seed(0))
        assert all(torch.equal(a, b) for a, b in zip(
            jax.tree.leaves(tp), jax.tree.leaves(again)))


def test_param_counts():
    published = {"qwen2.5-3b": 3.09, "phi3-mini-3.8b": 3.82,
                 "deepseek-coder-33b": 33.3, "mamba2-1.3b": 1.34,
                 "kimi-k2-1t-a32b": 1041.0}
    for arch in tconfigs.ARCH_IDS:
        for name in ("CONFIG", "SMOKE"):
            tcfg = getattr(tconfigs.get_arch(arch), name)
            jcfg = getattr(jconfigs.get_arch(arch), name)
            assert tapi.param_counts(tcfg) == japi.param_counts(jcfg), \
                (arch, name)
        if arch in published:
            assert tapi.param_counts(tconfigs.get_config(arch))[0] / 1e9 == \
                pytest.approx(published[arch], rel=0.02), arch
    assert tapi.param_counts(tconfigs.get_config("kimi-k2-1t-a32b")) == \
        (1_041_166_988_288, 31_061_144_576)


def test_init_cache_matches_cache_specs():
    cases = SMOKES + [(a, None) for a in tconfigs.ARCH_IDS if a not in DENSE]
    for arch, window in cases:
        jcfg, tcfg = configs(arch, window)
        for B, smax in ((3, 16), (1, 40)):
            spec = jax.tree.leaves(japi.cache_specs(jcfg, B, smax))
            got = tapi.cache_leaves(tapi.build_model(tcfg).init_cache(
                B, smax, device="cpu"))
            assert len(got) == len(spec), arch
            for t, s in zip(got, spec):
                assert tuple(t.shape) == s.shape, arch
                assert str(t.dtype).split(".")[1] == str(s.dtype)
                assert not t.any()


def test_cache_batch_dims():
    """Each cache leaf's batch dim, from the family's layout, is the dim
    that has the batch size (checked at a batch unlike every other dim)."""
    for arch in tconfigs.ARCH_IDS:
        cfg = tconfigs.get_arch(arch).SMOKE
        cache = tapi.build_model(cfg).init_cache(7, 24, device="cpu")
        dims = tapi.cache_leaves(tapi.cache_map(
            lambda c, d: torch.tensor(d), cache, tapi.cache_batch_dims(cfg)))
        for t, d in zip(tapi.cache_leaves(cache), dims):
            assert t.shape[int(d)] == 7 and list(t.shape).count(7) == 1, \
                arch


def test_configs_equal_field_for_field():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.SHAPES == jconfigs.SHAPES
    assert tconfigs.cells() == jconfigs.cells()
    fields = [f.name for f in dataclasses.fields(jconfigs.get_config(
        "internlm2-1.8b"))]
    assert fields == [f.name for f in dataclasses.fields(
        tconfigs.get_config("internlm2-1.8b"))]
    for arch in jconfigs.ARCH_IDS:
        jmod, tmod = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
        assert tmod.SKIPS == jmod.SKIPS
        for name in ("CONFIG", "SMOKE"):
            a, b = getattr(jmod, name), getattr(tmod, name)
            for f in fields:
                assert getattr(a, f) == getattr(b, f), (arch, name, f)
            assert (a.hd, str(a.pdt), str(a.cdt)) == \
                (b.hd, str(b.pdt).split(".")[1], str(b.cdt).split(".")[1])
