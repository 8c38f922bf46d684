"""The port's moe, ssm, hybrid and encdec families (``repro_torch.models``:
``ssm``, ``rglru``, ``layers.moe_ffn``, ``lm``, ``api``) against the JAX
package's on the CPU: the same inputs, made with numpy from a seed, and
the same params (drawn with numpy in the port's init shapes and dtypes:
``_lm_cases.numpy_params``).

* units: ``ssd_chunked`` (a sequence that is no multiple of the chunk),
  ``ssd_decode_step``, ``causal_conv`` with and without a cache,
  ``rglru_scan`` / ``rglru_step`` (a log-depth scan against JAX's
  ``associative_scan``: float32 tolerance), ``softplus`` / ``gelu``, and
  ``moe_ffn`` with a capacity below demand (dropped pairs): its output,
  routing and aux loss;
* whole models: for the SMOKE of kimi-k2, llama4-maverick, mamba2,
  recurrentgemma (a prompt past its window of 16: the ring cache) and
  whisper (with ``frames`` / ``enc_out``), the train-mode forward, the
  prefill and 3 decode steps, logits and every cache leaf within 1e-5
  (``F32_TOL``); mamba2 once in bfloat16 (JAX op by op, ``BF16_TOL``);
* the init: large leaves drawn in slices (the same generator gives the
  same tree; each leaf's mean and spread those of N(0, scale^2)); the
  nested hybrid / encdec trees through ``convert`` and back, float32
  leaves kept.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import rglru as JRG
from repro.models import ssm as JSSM
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.models import api as tapi
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm
from repro_torch.models import rglru as TRG
from repro_torch.models import ssm as TSSM

from _lm_cases import numpy_params
from test_torch_models import BF16_TOL, F32_TOL, close, run_both


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tensors here are small: one intra-op thread keeps torch's pool
    from spinning against the JAX side and the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(*arrays):
    """The same numpy arrays as JAX arrays and as torch tensors."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,chunk", [(13, 4), (8, 8), (5, 16)])
def test_ssd_chunked(S, chunk):
    rng = np.random.default_rng(S)
    B, H, P, N = 2, 3, 4, 5
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (B, S, H)).astype(np.float32)
    A = -rng.uniform(0.2, 2.0, (H,)).astype(np.float32)
    Bc = rng.normal(size=(B, S, N)).astype(np.float32)
    Cc = rng.normal(size=(B, S, N)).astype(np.float32)
    D = rng.normal(size=(H,)).astype(np.float32)
    j, t = both(x, dt, A, Bc, Cc, D)
    jy, jh = jax.jit(JSSM.ssd_chunked, static_argnames="chunk")(
        *j, chunk=chunk)
    ty, th = TSSM.ssd_chunked(*t, chunk=chunk)
    close(ty, jy, what="y")
    close(th, jh, what="final state")
    assert th.dtype == torch.float32
    h0 = rng.normal(size=(B, H, P, N)).astype(np.float32)
    j, t = both(x[:, 0], dt[:, 0], A, Bc[:, 0], Cc[:, 0], D, h0)
    for a, b in zip(TSSM.ssd_decode_step(*t),
                    jax.jit(JSSM.ssd_decode_step)(*j)):
        close(a, b, what="decode step")


def test_causal_conv():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    tail = rng.normal(size=(2, 3, 6)).astype(np.float32)
    j, t = both(x, w, tail)
    for a, b in zip(TSSM.causal_conv(t[0], t[1]),
                    JSSM.causal_conv(j[0], j[1])):
        close(a, b, what="no cache")
    for a, b in zip(TSSM.causal_conv(*t), JSSM.causal_conv(*j)):
        close(a, b, what="with a cache")
    # one token against the cache (decode)
    for a, b in zip(TSSM.causal_conv(t[0][:, :1], t[1], t[2]),
                    JSSM.causal_conv(j[0][:, :1], j[1], j[2])):
        close(a, b, what="one token")


@pytest.mark.parametrize("S", [1, 6, 17])
def test_rglru(S):
    rng = np.random.default_rng(S)
    x, r, i = (rng.normal(size=(2, S, 8)).astype(np.float32) * 2
               for _ in range(3))
    lam = rng.normal(size=(8,)).astype(np.float32)
    h0 = rng.normal(size=(2, 8)).astype(np.float32)
    j, t = both(x, r, i, lam)
    for a, b in zip(TRG.rglru_scan(*t), jax.jit(JRG.rglru_scan)(*j)):
        close(a, b, what="scan")
    j, t = both(x[:, 0], r[:, 0], i[:, 0], lam, h0)
    for a, b in zip(TRG.rglru_step(*t), jax.jit(JRG.rglru_step)(*j)):
        close(a, b, what="step")


def test_activations():
    x = np.linspace(-40, 40, 2001).astype(np.float32)
    close(TL.softplus(torch.from_numpy(x)), jax.nn.softplus(jnp.asarray(x)))
    close(TL.gelu(torch.from_numpy(x)), jax.nn.gelu(jnp.asarray(x)))
    xb = torch.from_numpy(x).bfloat16()
    got = TL.gelu(xb)
    assert got.dtype == torch.bfloat16
    close(got, jax.nn.gelu(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32),
          BF16_TOL)


@pytest.mark.parametrize("cf,top_k", [(0.5, 2), (1.25, 1), (4.0, 3)])
def test_moe_ffn(cf, top_k):
    """Capacity 0.5 drops about half the pairs; 4.0 drops none. Router
    logits are spread (no near ties), so both packages route alike."""
    rng = np.random.default_rng(top_k)
    B, S, d, E, f = 2, 9, 16, 6, 12
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    router = rng.normal(size=(d, E)).astype(np.float32)
    w1, w3 = (rng.normal(size=(E, d, f)).astype(np.float32) / 4
              for _ in range(2))
    w2 = rng.normal(size=(E, f, d)).astype(np.float32) / 4
    j, t = both(x, router, w1, w3, w2)
    kw = dict(top_k=top_k, capacity_factor=cf)
    jy, jaux = jax.jit(lambda *a: JL.moe_ffn(*a, dtype=jnp.float32, **kw))(
        *j)
    ty, taux = TL.moe_ffn(*t, dtype=torch.float32, **kw)
    close(ty, jy, what="moe output")
    close(taux, jaux, what="aux loss")
    # the routing against a numpy reading of JAX's rule
    T = B * S
    logits = x.reshape(T, d) @ router
    C = TL.moe_capacity(T, top_k, E, cf)
    r = TL.moe_route(torch.from_numpy(logits), top_k, C)
    gidx = np.argsort(-logits, axis=1, kind="stable")[:, :top_k]
    np.testing.assert_array_equal(r["gidx"].numpy(), gidx)
    seen = np.zeros(E, int)
    kept = 0
    for e, tok in sorted((e, tok) for tok in range(T) for e in gidx[tok]):
        kept += seen[e] < C
        seen[e] += 1
    assert int(r["keep"].sum()) == kept
    assert (kept < T * top_k) == (cf == 0.5)


def test_moe_ffn_bf16_drops_nothing_twice():
    """bfloat16 dispatch: the kept pairs fill distinct slots (the drop
    scatter masks the overflow first), each token gets at most top_k
    contributions."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(1, 32, 8)).astype(np.float32))
    router = torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32))
    r = TL.moe_route(x.reshape(32, 8) @ router, 2, TL.moe_capacity(32, 2, 4,
                                                                   0.5))
    slots = r["slot"][r["keep"]]
    assert len(torch.unique(slots)) == len(slots)
    assert int(r["keep"].sum()) < 64
    w = [torch.randn(4, 8, 8, generator=torch.Generator().manual_seed(i))
         .bfloat16() for i in range(3)]
    y, _ = TL.moe_ffn(x.bfloat16(), router, *w, top_k=2,
                      capacity_factor=0.5, dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

NEW = ["kimi-k2-1t-a32b", "llama4-maverick-400b-a17b", "mamba2-1.3b",
       "recurrentgemma-9b", "whisper-small"]


@pytest.mark.parametrize("arch", NEW)
def test_model_matches_jax(arch):
    jcfg = jconfigs.get_arch(arch).SMOKE
    tcfg = tconfigs.get_arch(arch).SMOKE
    jp, tp = numpy_params(tcfg)
    rng = np.random.default_rng(11)
    # recurrentgemma: past its window of 16, so the prefill takes the ring
    S = 21 if tcfg.family == "hybrid" else 13
    toks = rng.integers(0, tcfg.vocab, (2, S)).astype(np.int32)
    frames = None
    if tcfg.family == "encdec":
        frames = rng.normal(size=(2, 24, tcfg.d_model)).astype(np.float32)
    run_both(jcfg, tcfg, jp, tp, toks, frames=frames)


def test_model_matches_jax_bf16():
    """mamba2 SMOKE in bfloat16: every leaf bfloat16 but the float32 ones
    of the JAX init (A_log, D, dt_bias), in both packages; the JAX side op
    by op (``run_both`` turns jit off for bfloat16)."""
    kw = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg = jconfigs.get_arch("mamba2-1.3b").SMOKE.scaled(**kw)
    tcfg = tconfigs.get_arch("mamba2-1.3b").SMOKE.scaled(**kw)
    jp, tp = numpy_params(tcfg, seed=2)
    toks = np.random.default_rng(4).integers(0, tcfg.vocab, (2, 10)) \
        .astype(np.int32)
    run_both(jcfg, tcfg, jp, tp, toks, steps=2, tol=BF16_TOL)


# ---------------------------------------------------------------------------
# the init and the conversion
# ---------------------------------------------------------------------------

def test_dense_init_in_slices(monkeypatch):
    """With a slice of 1000 elements every SMOKE leaf past it is drawn in
    slices: the same generator still gives the same tree, and each drawn
    leaf's mean and spread are those of N(0, scale^2)."""
    monkeypatch.setattr(TL, "INIT_SLICE", 1000)
    cfg = tconfigs.get_arch("recurrentgemma-9b").SMOKE
    m = tapi.build_model(cfg)
    a = m.init(torch.Generator().manual_seed(3))
    b = m.init(3, device="cpu")
    la, lb = tlm_leaves(a), tlm_leaves(b)
    assert len(la) == len(lb)
    for (name, x), (_, y) in zip(la, lb):
        assert torch.equal(x, y), name
    sliced = 0
    for name, x in la:
        if x.numel() <= 1000 or name.endswith(("ln", "ln1", "ln2", "lam")):
            continue
        sliced += 1
        scale = 0.02 if name == "embed" else (
            0.5 if name.endswith("conv_w") else None)
        if scale is None:      # 1 / sqrt(leading dim as drawn)
            drawn = x.shape[0] * (x.shape[1] if name.startswith("groups")
                                  else 1)
            scale = 1 / np.sqrt(drawn)
        z = x.double() / scale
        n = z.numel()
        assert abs(float(z.mean())) < 5 / np.sqrt(n), name
        assert abs(float(z.std()) - 1) < 5 / np.sqrt(n) + 0.02, name
    assert sliced >= 10


def tlm_leaves(tree, prefix=""):
    out = []
    for k, v in tree.items():
        name = f"{prefix}{k}"
        out += tlm_leaves(v, name + ".") if isinstance(v, dict) \
            else [(name, v)]
    return out


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "whisper-small"])
def test_params_round_trip_nested_bf16(arch):
    """The nested trees (hybrid groups and tail, encdec encoder and
    decoder) in bfloat16 through ``convert`` and back: every leaf's bytes
    and dtype kept, the float32 leaves float32."""
    tcfg = tconfigs.get_arch(arch).SMOKE.scaled(param_dtype="bfloat16")
    jp, tp = numpy_params(tcfg)
    jp = jax.tree.map(np.asarray, jp)
    back = lm_params_to_numpy(tp)
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_j, flat_b):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    again = lm_params_from_numpy(back, "cpu")
    for (_, a), (_, b) in zip(tlm_leaves(tp), tlm_leaves(again)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if arch == "recurrentgemma-9b":
        assert tp["groups"]["rec"]["lam"].dtype == torch.float32
        assert tp["groups"]["rec"]["wx"].dtype == torch.bfloat16
        assert tp["groups"]["rec"]["wx"].dim() == 4
