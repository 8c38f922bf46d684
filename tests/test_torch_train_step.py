"""The port's train step (``repro_torch.train.make_train_step``) against
the JAX package's on the CPU, in float32: 3 steps from the same state
(JAX's, carried across with ``convert.train_state_from_numpy``) on the
same ``TokenStream`` batches.

Cases: internlm2-1.8b SMOKE at accum 1, and at accum 2 with an int8
``grad_transform`` (each gradient leaf quantized and dequantized,
``dist.compress``); kimi-k2 SMOKE (moe) with Adafactor. Per step the loss
and the gradient norm within rtol 1e-4; after the last step every param
within rtol 1e-4 plus an atol of twice the largest learning rate of the
3 steps: AdamW's first updates are about ``lr * sign(g)``, so a gradient
element near 0 can take the other sign in one package and move its param
by up to 2 lr (an int8 code can also round the other way). The count and
step equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import TokenStream
from repro.dist import compress as jc
from repro.models import api as japi
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.convert import train_state_from_numpy
from repro_torch.dist import compress as tc
from repro_torch.models import api as tapi
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep
from repro_torch.tree import flatten_with_path, tree_map

from _lm_cases import numpy_params

STEPS = 3
PEAK_LR = 3e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def j_int8(grads):
    return jax.tree.map(lambda g: jc.dequantize_int8(*jc.quantize_int8(g)),
                        grads)


def t_int8(grads):
    return tree_map(lambda g: tc.dequantize_int8(*tc.quantize_int8(g)),
                    grads)


@pytest.mark.parametrize("arch,opt,accum,int8", [
    ("internlm2-1.8b", "adamw", 1, False),
    ("internlm2-1.8b", "adamw", 2, True),
    ("kimi-k2-1t-a32b", "adafactor", 1, False),
])
def test_train_step_matches_jax(arch, opt, accum, int8):
    jcfg = jconfigs.get_arch(arch).SMOKE
    tcfg = tconfigs.get_arch(arch).SMOKE
    jp, _ = numpy_params(tcfg, seed=11)
    jo = getattr(jopt, opt)(jopt.cosine_schedule(PEAK_LR, 2, 6))
    to = getattr(topt, opt)(topt.cosine_schedule(PEAK_LR, 2, 6))
    jstate = jstep.TrainState(params=jp, opt_state=jo.init(jp),
                              step=jnp.zeros((), jnp.int32))
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    jfn = jax.jit(jstep.make_train_step(
        japi.build_model(jcfg), jo, accum=accum,
        grad_transform=j_int8 if int8 else None))
    tfn = tstep.make_train_step(tapi.build_model(tcfg), to, accum=accum,
                                grad_transform=t_int8 if int8 else None)
    stream = TokenStream(tcfg.vocab, 4, 24, seed=2)
    lrs = []
    for i in range(STEPS):
        b = next(stream)
        if accum > 1:
            b = {k: v.reshape((accum, -1) + v.shape[1:]) for k, v in b.items()}
        jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tfn(tstate, {k: torch.as_tensor(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"loss, step {i}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4,
                                   err_msg=f"grad norm, step {i}")
        lrs.append(float(topt.cosine_schedule(PEAK_LR, 2, 6)(i + 1)))
    assert int(tstate.step) == int(jstate.step) == STEPS
    assert int(tstate.opt_state["count"]) == STEPS
    jflat = {"/".join(str(k.key) for k in p): v for p, v in
             jax.tree_util.tree_flatten_with_path(jstate.params)[0]}
    for path, t in flatten_with_path(tstate.params):
        np.testing.assert_allclose(t.numpy(), np.asarray(jflat["/".join(path)]),
                                   rtol=1e-4, atol=2 * max(lrs),
                                   err_msg="/".join(path))
