"""Public model API of the port: ``build_model(cfg) -> Model`` (init /
prefill / decode / init_cache) and exact parameter accounting, for
every family. Counterpart of ``repro.models.api``; ``train_loss`` waits
for the training slice.

  prefill(params, batch, cache) -> (last-position logits, cache)
  decode(params, batch, cache)  -> (logits of ONE new token, cache)

Both update ``cache`` in place and return it (the JAX engine donates its
cache to the decode; here nothing is copied). ``encdec``: the prefill's
batch carries ``frames`` (B, S_enc, d), the stub frontend's embeddings,
which it encodes; the decode's carries the encoder's states ``enc_out``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch

from .. import resolve_device
from . import lm
from .config import ModelConfig
from .ssm import SSMCache


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable          # (generator or seed, device) -> params
    logical_specs: Any      # dict of logical axis tuples (parallel to params)
    prefill: Callable       # (params, batch, cache) -> (logits, cache)
    decode: Callable        # (params, batch, cache) -> (logits, cache)
    init_cache: Callable    # (batch, smax, device) -> cache


def _cache_struct(cfg: ModelConfig, B: int, smax: int, device="cuda"):
    """The zero cache of ``cfg``'s family, the JAX package's tree:

    * dense / vlm / moe / encdec (the decoder's self-attention):
      ``(k, v, cache_len)``, k / v (L, B, s, Hkv, hd) in the compute
      dtype, s = smax (the window where there is one);
    * ssm: ``SSMCache(h (L, B, H, P, N) float32, conv (L, B, W-1, C))``;
    * hybrid: ``(((h (G, R, B, Dr) float32, conv (G, R, B, W-1, Dr)),
      (k, v (G, A, B, s, Hkv, hd), cache_len (G, A, B))), tail)`` with
      ``tail = (h (rest, B, Dr), conv (rest, B, W-1, Dr))`` or None.

    ``cache_batch_dims`` gives each leaf's batch dim."""
    dev = resolve_device(device)
    dt, hd, Hkv = cfg.cdt, cfg.hd, cfg.kv_heads
    f32, i32 = torch.float32, torch.int32

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def kv(lead, s):
        return (zeros(lead + (B, s, Hkv, hd)), zeros(lead + (B, s, Hkv, hd)),
                zeros(lead + (B,), i32))

    if cfg.family in ("dense", "vlm", "moe"):
        return kv((cfg.layers,), smax if cfg.window is None
                  else min(smax, cfg.window))
    if cfg.family == "encdec":
        return kv((cfg.dec_layers,), smax)
    if cfg.family == "ssm":
        din = cfg.ssm_expand * cfg.d_model
        H = cfg.ssm_heads or (din // cfg.ssm_head_dim)
        return SSMCache(
            h=zeros((cfg.layers, B, H, din // H, cfg.ssm_state), f32),
            conv=zeros((cfg.layers, B, cfg.conv_width - 1,
                        din + 2 * cfg.ssm_state)))
    if cfg.family == "hybrid":
        G, R, A, rest = _hybrid_counts(cfg)
        Dr = cfg.lru_width or cfg.d_model
        W = min(smax, cfg.window or smax)
        rec = (zeros((G, R, B, Dr), f32),
               zeros((G, R, B, cfg.conv_width - 1, Dr)))
        tail = None
        if rest:
            tail = (zeros((rest, B, Dr), f32),
                    zeros((rest, B, cfg.conv_width - 1, Dr)))
        return ((rec, kv((G, A), W)), tail)
    raise ValueError(cfg.family)


def _hybrid_counts(cfg: ModelConfig):
    """(groups, rec layers a group, attention layers a group, tail layers)."""
    unit = len(cfg.pattern)
    G = cfg.layers // unit
    R = sum(1 for t in cfg.pattern if t == "rec")
    return G, R, unit - R, cfg.layers - G * unit


def cache_batch_dims(cfg: ModelConfig):
    """The batch dim of every leaf of ``_cache_struct``'s tree, in the same
    tree: known from the family's layout, never guessed from sizes (the
    JAX engine picks it by size, ``repro/serve/engine.py:_merge_slot``)."""
    if cfg.family in ("dense", "vlm", "moe", "encdec"):
        return (1, 1, 1)
    if cfg.family == "ssm":
        return SSMCache(h=1, conv=1)
    if cfg.family == "hybrid":
        tail = (1, 1) if _hybrid_counts(cfg)[3] else None
        return (((2, 2), (2, 2, 2)), tail)
    raise ValueError(cfg.family)


def cache_map(fn, *trees):
    """``fn`` over the leaves of parallel cache trees (tuples, including
    ``SSMCache``; None stays None)."""
    t = trees[0]
    if t is None:
        return None
    if isinstance(t, tuple):
        out = [cache_map(fn, *parts) for parts in zip(*trees)]
        return type(t)(*out) if hasattr(t, "_fields") else tuple(out)
    return fn(*trees)


def cache_leaves(tree):
    """The tensors of a cache tree in order (None subtrees skipped), as
    ``jax.tree.leaves`` lists the JAX package's."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [x for t in tree for x in cache_leaves(t)]
    return [tree]


def _generator(generator_or_seed, device) -> torch.Generator:
    if isinstance(generator_or_seed, torch.Generator):
        return generator_or_seed
    return torch.Generator(device=resolve_device(device)).manual_seed(
        int(generator_or_seed))


def build_model(cfg: ModelConfig) -> Model:
    lm.check_family(cfg)
    _, logical = lm.init_params(cfg, device="meta")

    def init(generator_or_seed, device="cuda"):
        """Random params from a ``torch.Generator`` (on its device) or a
        seed (a generator on ``device``)."""
        params, _ = lm.init_params(cfg, _generator(generator_or_seed,
                                                   device))
        return params

    @torch.no_grad()
    def prefill(params, batch, cache):
        tokens = batch["tokens"]
        pos = batch.get("positions")
        if pos is None:
            pos = lm.make_positions(cfg, tokens)
        enc_out = None
        if cfg.family == "encdec":
            enc_out = lm.encode(cfg, params, batch["frames"])
        h, cache, _ = lm.forward(cfg, params, tokens, pos, "prefill",
                                 cache=cache, enc_out=enc_out)
        return lm._unembed(cfg, params, h[:, -1:])[:, 0], cache

    @torch.no_grad()
    def decode(params, batch, cache):
        token = batch["token"]            # (B,)
        pos = batch["pos"]                # (B,) absolute position
        if cfg.pos == "mrope":
            p3 = batch.get("positions")
            posx = p3 if p3 is not None else torch.stack([pos[:, None]] * 3)
        else:
            posx = pos[:, None]
        h, cache, _ = lm.forward(cfg, params, token[:, None], posx,
                                 "decode", cache=cache,
                                 enc_out=batch.get("enc_out"))
        return lm._unembed(cfg, params, h[:, -1:])[:, 0], cache

    return Model(cfg=cfg, init=init, logical_specs=logical,
                 prefill=prefill, decode=decode,
                 init_cache=functools.partial(_cache_struct, cfg))


def param_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(total, active) parameter counts from the init shapes, built on
    ``torch.device("meta")``: nothing is allocated. Active: the expert
    leaves (``we*``) count top_k / n_experts of their size."""
    params, _ = lm.init_params(cfg, device="meta")
    total = expert = 0
    stack = [((), params)]
    while stack:
        path, tree = stack.pop()
        for k, v in tree.items():
            if isinstance(v, dict):
                stack.append((path + (k,), v))
                continue
            total += v.numel()
            if any("we" in name for name in path + (k,)):
                expert += v.numel()
    if cfg.family == "moe" and cfg.n_experts:
        return total, total - expert + expert * cfg.top_k // cfg.n_experts
    return total, total
