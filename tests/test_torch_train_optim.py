"""The port's optimizers (``repro_torch.train.optimizer``) and gradient
compression (``repro_torch.dist.compress``) against the JAX package's on
the CPU, on the same inputs drawn with numpy from a seed.

The schedule at steps 0, in the warmup, at its end, at the horizon and
past it (float32, rtol 1e-6); ``global_norm`` and the clip (rtol 1e-6);
one AdamW and one Adafactor update elementwise from the same grads and
state, on 3-D, 2-D and 1-D leaves, in float32 and with bfloat16 params
(updates and new moments within rtol 1e-5 / atol 1e-7 for float32, the
bfloat16 updates within one bfloat16 rounding, rtol 8e-3); int8 codes
bit-exact and scales equal, along no axis and along each axis; the
error-feedback case of ``tests/test_dist.py`` run through the port.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.dist import compress as jc
from repro.train import optimizer as jopt
from repro_torch.convert import lm_params_from_numpy
from repro_torch.dist import compress as tc
from repro_torch.train import optimizer as topt
from repro_torch.tree import flatten_with_path

F32 = dict(rtol=1e-5, atol=1e-7)


def tensors(tree):
    return lm_params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def host(t):
    return t.float().numpy() if torch.is_tensor(t) else \
        np.asarray(jnp.asarray(t, jnp.float32))


def draw(seed, dtype=np.float32):
    """A params-like tree: a stacked 3-D leaf, a matrix, a vector, a
    nested dict."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": (40, 12), "final_ln": (12,),
              "layers": {"w1": (3, 12, 20), "ln1": (3, 12)}}

    def mk(s):
        return rng.normal(size=s).astype(np.float32).astype(dtype)
    return jax.tree.map(mk, shapes, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("step", [0, 1, 5, 19, 20, 21, 60, 99, 100, 250])
def test_cosine_schedule(step):
    jl = jopt.cosine_schedule(3e-4, 20, 100)(jnp.asarray(step, jnp.int32))
    tl = topt.cosine_schedule(3e-4, 20, 100)(
        torch.tensor(step, dtype=torch.int32))
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_global_norm_and_clip(max_norm):
    g = draw(1)
    jc_tree, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                           max_norm)
    tg = tensors(g)
    np.testing.assert_allclose(float(topt.global_norm(tg)), float(jn),
                               rtol=1e-6)
    tc_tree, tn = topt.clip_by_global_norm(tg, max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, (_, b) in zip(jax.tree.leaves(jc_tree),
                         flatten_with_path(tc_tree)):
        np.testing.assert_allclose(host(b), host(a), rtol=1e-6)


def _state_after(jopt_, topt_, params, grads, warm_steps):
    """Both optimizers' states after ``warm_steps`` updates from the same
    grads (so the moments are non-zero), the port's from the JAX state."""
    jp = jax.tree.map(jnp.asarray, params)
    jg = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), grads)
    st = jopt_.init(jp)
    for _ in range(warm_steps):
        _, st = jopt_.update(jg, st, jp)
    tst = {k: tensors(v) if isinstance(v, dict) else
           torch.as_tensor(np.array(v)) for k, v in st.items()}
    return jp, jg, st, tst


@pytest.mark.parametrize("pdtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_one_update_matches_jax(name, pdtype):
    lr = jopt.cosine_schedule(1e-2, 3, 50)
    tlr = topt.cosine_schedule(1e-2, 3, 50)
    jo = getattr(jopt, name)(lr)
    to = getattr(topt, name)(tlr)
    params, grads = draw(2, pdtype), draw(3)
    jp, jg, st, tst = _state_after(jo, to, params, grads, warm_steps=2)
    g2 = draw(4)                                   # the update's grads
    ju, jst = jo.update(jax.tree.map(jnp.asarray, g2), st, jp)
    tu, tst = to.update(tensors(g2), tst, tensors(params))
    assert int(tst["count"]) == int(jst["count"]) == 3
    u_tol = F32 if pdtype == np.float32 else dict(rtol=8e-3, atol=1e-7)
    jflat = jax.tree_util.tree_flatten_with_path(ju)[0]
    tflat = flatten_with_path(tu)
    assert [tuple(str(k.key) for k in p) for p, _ in jflat] == \
        [p for p, _ in tflat]
    for (path, a), (_, b) in zip(jflat, tflat):
        assert b.dtype == lm_params_from_numpy(
            {"x": np.asarray(a)}, "cpu")["x"].dtype, path
        np.testing.assert_allclose(host(b), host(a), err_msg=str(path),
                                   **u_tol)
    key = "m" if name == "adamw" else "s"
    for a, b in zip(jax.tree.leaves(jst[key]),
                    [x for _, x in flatten_with_path(tst[key])]):
        np.testing.assert_allclose(host(b), host(a), **F32)
    if name == "adamw":
        for a, b in zip(jax.tree.leaves(jst["v"]),
                        [x for _, x in flatten_with_path(tst["v"])]):
            np.testing.assert_allclose(host(b), host(a), **F32)


def test_optimizer_state_trees_match_jax():
    """The state's tree: AdamW's float32 ``m`` / ``v`` beside an int32
    count; Adafactor's row / column statistics for matrices, a full
    moment for vectors."""
    params = draw(5, ml_dtypes.bfloat16)
    tp = tensors(params)
    for name in ("adamw", "adafactor"):
        js = getattr(jopt, name)(lambda c: 1e-3).init(
            jax.tree.map(jnp.asarray, params))
        ts = getattr(topt, name)(lambda c: 1e-3).init(tp)
        jflat = jax.tree_util.tree_flatten_with_path(js)[0]
        tflat = flatten_with_path(ts)
        assert [tuple(str(k.key) for k in p) for p, _ in jflat] == \
            [p for p, _ in tflat]
        for (_, a), (_, b) in zip(jflat, tflat):
            assert tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype) == str(b.dtype).split(".")[1]


@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("seed", [0, 7])
def test_int8_codes_bit_exact(seed, axis):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 3, (33, 17)).astype(np.float32)
    x[3] = 0.0                                  # a zero slice: scale 1
    x[5, :4] = [0.5, -0.5, 1.5, 2.5]            # ties round to even
    jq, js = jc.quantize_int8(jnp.asarray(x), axis)
    tq, ts = tc.quantize_int8(torch.as_tensor(x), axis)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.dequantize_int8(tq, ts).numpy(),
                                  np.asarray(jc.dequantize_int8(jq, js)))


def test_error_feedback_matches_jax_and_accumulates():
    """``tests/test_dist.py``'s error-feedback case on the port: the
    accumulated compressed signal tracks the true one within the final
    residual, the residual stays under 0.2; every step's output and
    residual equal the JAX package's."""
    rng = np.random.default_rng(0)
    residual = torch.zeros(32)
    jres = jnp.zeros((32,))
    acc_true = np.zeros((32,))
    acc_comp = np.zeros((32,))
    for _ in range(200):
        g = rng.normal(0, 1, (32,)).astype(np.float32)
        deq, residual = tc.error_feedback(torch.as_tensor(g), residual)
        jdeq, jres = jc.error_feedback(jnp.asarray(g), jres)
        np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))
        np.testing.assert_array_equal(residual.numpy(), np.asarray(jres))
        acc_true += g
        acc_comp += deq.numpy()
    assert np.abs(acc_true - acc_comp).max() == pytest.approx(
        np.abs(residual.numpy()).max(), abs=1e-4)
    assert np.abs(residual.numpy()).max() < 0.2
