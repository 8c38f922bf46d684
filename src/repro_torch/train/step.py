"""Train step of the port (counterpart of ``repro.train.step``): the loss
and its gradients by autograd, micro-batch accumulation, the
``grad_transform`` hook, the global-norm clip and the optimizer.

The step updates the state in place (the params, the optimizer's
moments) and returns it: the JAX step is jitted with the state donated
(``donate_argnums=(0,)``), so no caller of it keeps the old state either.
The accumulator of ``accum`` > 1 micro-batches is float32, as the JAX
step's ``lax.scan`` sum is.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from ..dist.local_ops import place_like
from ..tree import leaves, unflatten
from .optimizer import Optimizer, clip_by_global_norm

__all__ = ["TrainState", "init_train_state", "make_train_step"]


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor


def init_train_state(model, optimizer: Optimizer, generator_or_seed=0,
                     device="cuda") -> TrainState:
    """Random params from ``model.init`` (a ``torch.Generator`` on its
    device, or a seed on ``device``), the optimizer's zero state and step
    0 (int32)."""
    params = model.init(generator_or_seed, device)
    dev = leaves(params)[0].device
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def make_train_step(model, optimizer: Optimizer, *, accum: int = 1,
                    max_grad_norm: float = 1.0,
                    grad_transform: Optional[Callable] = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` leaves are (accum, mb, ...) when accum > 1, else (B, ...).
    ``grad_transform`` maps the gradient tree (the params' structure)
    before the clip: gradient compression, custom reductions.
    ``metrics``: ``loss`` (the mean over micro-batches), ``grad_norm``
    (before the clip), ``step`` (after it), tensors on the device.
    """

    def value_and_grad(params, mb):
        flat = leaves(params)
        live = [p.detach().requires_grad_(True) for p in flat]
        with torch.enable_grad():
            loss = model.train_loss(unflatten(params, live), mb)
            grads = torch.autograd.grad(loss, live)
        return loss.detach(), [place_like(g, p) for g, p in zip(grads, flat)]

    def train_step(state: TrainState, batch):
        params = state.params
        if accum > 1:
            gsum = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in leaves(params)]
            losses = []
            for i in range(accum):
                loss, g = value_and_grad(params, {k: v[i] for k, v in
                                                  batch.items()})
                for a, b in zip(gsum, g):
                    a.add_(b)
                del g
                losses.append(loss)
            for a in gsum:
                a.div_(accum)
            grads = unflatten(params, gsum)
            loss = torch.stack(losses).mean()
        else:
            loss, g = value_and_grad(params, batch)
            grads = unflatten(params, g)

        if grad_transform is not None:
            grads = grad_transform(grads)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, state.opt_state,
                                                  params)
            del grads
            for p, u in zip(leaves(params), leaves(updates)):
                p.add_(u.to(p.dtype))
        new_state = TrainState(params=params, opt_state=opt_state,
                               step=state.step + 1)
        return new_state, {"loss": loss, "grad_norm": gnorm,
                           "step": new_state.step}

    return train_step
