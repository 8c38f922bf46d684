"""The port's training loss (``models.api.train_loss``, ``lm.xent_chunked``,
remat) against the JAX package's on the CPU, in float32: for every SMOKE
arch the loss and every gradient leaf against ``jax.value_and_grad`` of
the JAX ``train_loss`` on the same params (drawn with numpy,
``_lm_cases.numpy_params``) and the same batch (drawn with numpy from a
seed, some labels masked with -1). The loss within rtol 1e-5; each
gradient leaf within rtol 1e-4 plus atol 1e-5 of its scale (``close``:
the leaf's largest magnitude, at least 1). Also ``xent_chunked`` alone
(S not a multiple of the chunk, masked labels), and the port's gradients
bit-equal with remat on and off.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.tree import flatten_with_path, leaves, unflatten

from _lm_cases import numpy_params

LOSS_TOL = dict(rtol=1e-5, atol=0.0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tensors here are small: one intra-op thread keeps torch's pool
    from spinning against the JAX side and the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(port, ref, tol=GRAD_TOL, what=""):
    """``port`` within ``rtol`` of ``ref`` elementwise, plus ``atol`` on
    the tensor's scale (its largest magnitude, at least 1)."""
    port = port.detach().float().numpy() if torch.is_tensor(port) else port
    ref = np.asarray(ref, np.float32)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(port, ref, rtol=tol["rtol"],
                               atol=tol["atol"] * scale, err_msg=what)


def batch_for(cfg, seed=0, B=2, S=24):
    """tokens, labels (a quarter masked with -1), encdec frames: numpy."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.25] = -1
    b["labels"] = labels
    if cfg.family == "encdec":
        b["frames"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    return b


def port_value_and_grad(model, params, batch):
    live = [p.detach().clone().requires_grad_(True) for p in leaves(params)]
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss = model.train_loss(unflatten(params, live), tb)
    grads = torch.autograd.grad(loss, live)
    return loss.detach(), unflatten(params, list(grads))


def assert_grads_close(tgrads, jgrads, tol=GRAD_TOL):
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(
                 jgrads)[0]}
    tflat = {"/".join(path): leaf for path, leaf in flatten_with_path(tgrads)}
    assert sorted(tflat) == sorted(jflat)
    for name, g in tflat.items():
        close(g, jflat[name], tol, what=name)


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_train_loss_and_grads_match_jax(arch):
    jcfg = jconfigs.get_arch(arch).SMOKE
    tcfg = tconfigs.get_arch(arch).SMOKE
    jp, tp = numpy_params(tcfg, seed=3)
    batch = batch_for(tcfg)
    jm = japi.build_model(jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.train_loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tgrads = port_value_and_grad(tapi.build_model(tcfg), tp, batch)
    np.testing.assert_allclose(float(tloss), float(jloss), **LOSS_TOL)
    assert_grads_close(tgrads, jgrads)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "kimi-k2-1t-a32b",
                                  "recurrentgemma-9b", "whisper-small"])
def test_remat_leaves_grads_unchanged(arch):
    """Checkpointed layers and loss chunks recompute on the same dtype
    path: the gradients with remat on equal those with it off, bit for
    bit (a loss of several chunks, so the chunk checkpoints run)."""
    cfg = tconfigs.get_arch(arch).SMOKE
    _, tp = numpy_params(cfg, seed=5)
    batch = batch_for(cfg, seed=1, S=20)
    out = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat, loss_chunk=8)
        out.append(port_value_and_grad(tapi.build_model(c), tp, batch))
    (l1, g1), (l0, g0) = out
    assert float(l1) == float(l0)
    for a, b in zip(leaves(g1), leaves(g0)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("S,chunk", [(30, 12), (24, 8), (7, 512)])
def test_xent_chunked_matches_jax(S, chunk):
    """The chunked loss alone, on random hidden states: padding to whole
    chunks, the -1 mask (some rows all masked), ``max(label, 0)``; the
    loss and its gradients with respect to h and the unembedding."""
    jcfg = jconfigs.get_arch("qwen2.5-3b").SMOKE
    tcfg = tconfigs.get_arch("qwen2.5-3b").SMOKE
    rng = np.random.default_rng(S * 100 + chunk)
    B, d = 3, tcfg.d_model
    h = rng.normal(size=(B, S, d)).astype(np.float32)
    labels = rng.integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.3] = -1
    labels[1] = -1                      # a row with no label at all
    w = {"final_ln": (1 + 0.1 * rng.normal(size=(d,))).astype(np.float32),
         "embed": (0.02 * rng.normal(size=(tcfg.vocab, d))
                   ).astype(np.float32)}
    if not tcfg.tie_embeddings:
        w["lm_head"] = (rng.normal(size=(d, tcfg.vocab)) / np.sqrt(d)
                        ).astype(np.float32)

    def jloss(hh, ww):
        return jlm.xent_chunked(jcfg, ww, hh, jnp.asarray(labels), chunk)
    jl, (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jax.tree.map(jnp.asarray, w))

    th = torch.as_tensor(h).requires_grad_(True)
    tw = {k: torch.as_tensor(v).requires_grad_(True) for k, v in w.items()}
    tl = tlm.xent_chunked(tcfg, tw, th, torch.as_tensor(labels), chunk)
    gh, *gw = torch.autograd.grad(tl, [th] + list(tw.values()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), **LOSS_TOL)
    close(gh, jgh, what="h")
    for (k, _), g in zip(tw.items(), gw):
        close(g, jgw[k], what=k)
