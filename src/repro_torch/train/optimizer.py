"""Optimizers of the port (counterpart of ``repro.train.optimizer``):
AdamW and Adafactor (factored second moment) over nested dicts of
tensors, plus the cosine LR schedule.

API as the JAX package's: ``opt.init(params) -> state``;
``opt.update(grads, state, params) -> (updates, state)``; the updates are
in each param's dtype. The state has the JAX package's tree:

* AdamW ``{"m", "v", "count"}``, ``m`` / ``v`` float32, ``count`` int32;
* Adafactor ``{"s", "count"}``, ``s`` holding ``{"vr", "vc"}`` for a leaf
  of rank >= 2 and ``{"v"}`` for a vector.

Arithmetic is float32 tensors on the params' device, as JAX's: the
schedule, ``b ** count``, the clip scale (cast to each leaf's dtype). A
Python float enters only as a constant, as JAX's weak-typed scalars do.
``update`` writes the new moments into the state's tensors (the JAX step
donates its state) and computes each leaf's float32 temporaries one leaf
at a time, so no float32 copy of the whole tree is made.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..tree import leaves, tree_map, unflatten

__all__ = ["Optimizer", "cosine_schedule", "global_norm",
           "clip_by_global_norm", "adamw", "adafactor"]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    """step (a tensor or an int) -> the float32 LR tensor: linear warmup
    to ``peak_lr``, then a cosine down to ``floor * peak_lr``."""
    def lr(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0, 1)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return peak_lr * torch.minimum(warm, cos)
    return lr


def global_norm(tree) -> torch.Tensor:
    """sqrt of the float32 sum of squares, leaf sums added in flattening
    order (JAX's ``sum`` over ``jax.tree.leaves``)."""
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm):
    """(the tree scaled by min(1, max_norm / norm), norm). Each leaf is
    scaled in place by the scale cast to its dtype, as JAX's
    ``x * scale.astype(x.dtype)`` rounds."""
    g = global_norm(tree)
    scale = torch.clamp_max(max_norm / torch.clamp_min(g, 1e-9), 1.0)
    for x in leaves(tree):
        x.mul_(scale.to(x.dtype))
    return tree, g


def adamw(lr_fn, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          dtype=torch.float32) -> Optimizer:
    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device)
        dev = leaves(params)[0].device
        return {"m": tree_map(z, params), "v": tree_map(z, params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params):
        c = state["count"] + 1
        lr = lr_fn(c)
        b1c = 1 - b1 ** c.to(torch.float32)
        b2c = 1 - b2 ** c.to(torch.float32)

        def upd(g, m, v, p):
            g32 = g.to(dtype)
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_((1 - b2) * g32 * g32)
            u = (m / b1c) / (torch.sqrt(v / b2c) + eps)
            u = u + weight_decay * p.to(dtype)
            return (-lr * u).to(p.dtype)

        updates = [upd(g, m, v, p) for g, m, v, p in zip(
            leaves(grads), leaves(state["m"]), leaves(state["v"]),
            leaves(params))]
        return unflatten(grads, updates), {"m": state["m"], "v": state["v"],
                                           "count": c}

    return Optimizer(init, update)


def adafactor(lr_fn, decay=0.8, eps=1e-30, clip_threshold=1.0,
              weight_decay=0.0) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern). Leaves of rank
    >= 2 keep row / column statistics of their last two dims; vectors keep
    full moments."""

    def init(params):
        def st(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        dev = leaves(params)[0].device
        return {"s": unflatten(params, [st(p) for p in leaves(params)]),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params):
        c = state["count"] + 1
        lr = lr_fn(c)
        beta = 1.0 - c.to(torch.float32) ** (-decay)

        def upd(g, s, p):
            g32 = g.float()
            g2 = g32 * g32 + eps
            if p.dim() >= 2:
                s["vr"].copy_(beta * s["vr"] + (1 - beta) *
                              torch.mean(g2, dim=-1))
                s["vc"].copy_(beta * s["vc"] + (1 - beta) *
                              torch.mean(g2, dim=-2))
                rms_r = s["vr"] / torch.mean(s["vr"], dim=-1, keepdim=True)
                u = g32 * torch.rsqrt(rms_r + eps)[..., None] * \
                    torch.rsqrt(s["vc"] + eps)[..., None, :]
            else:
                s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
                u = g32 * torch.rsqrt(s["v"] + eps)
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)   # update clipping
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (-lr * u).to(p.dtype)

        gl = leaves(grads)
        sl = _state_leaves(grads, state["s"])
        updates = [upd(g, s, p) for g, s, p in zip(gl, sl, leaves(params))]
        return unflatten(grads, updates), {"s": state["s"], "count": c}

    return Optimizer(init, update)


def _state_leaves(like, s):
    """The per-leaf state dicts of ``s`` at the leaf positions of ``like``
    (JAX's ``treedef.flatten_up_to``)."""
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in _state_leaves(like[k], s[k])]
    return [s]
