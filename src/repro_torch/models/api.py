"""Public model API of the port: ``build_model(cfg) -> Model`` (init /
prefill / decode / init_cache) and exact parameter accounting.
Counterpart of ``repro.models.api`` for the ``dense`` and ``vlm``
families; ``train_loss`` waits for the training slice.

  prefill(params, batch, cache) -> (last-position logits, cache)
  decode(params, batch, cache)  -> (logits of ONE new token, cache)

Both update ``cache`` in place and return it (the JAX engine donates its
cache to the decode; here nothing is copied).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch

from .. import resolve_device
from . import lm
from .config import ModelConfig


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable          # (generator or seed, device) -> params
    logical_specs: Any      # dict of logical axis tuples (parallel to params)
    prefill: Callable       # (params, batch, cache) -> (logits, cache)
    decode: Callable        # (params, batch, cache) -> (logits, cache)
    init_cache: Callable    # (batch, smax, device) -> cache


def _cache_struct(cfg: ModelConfig, B: int, smax: int, device="cuda"):
    """The zero cache ``(k, v, cache_len)``: k / v (L, B, s, Hkv, hd) in
    the compute dtype, s = smax (the window where there is one)."""
    dev = resolve_device(device)
    s = smax if cfg.window is None else min(smax, cfg.window)
    shape = (cfg.layers, B, s, cfg.kv_heads, cfg.hd)
    return (torch.zeros(shape, dtype=cfg.cdt, device=dev),
            torch.zeros(shape, dtype=cfg.cdt, device=dev),
            torch.zeros((cfg.layers, B), dtype=torch.int32, device=dev))


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
        h, cache, _ = lm.forward(cfg, params, tokens, pos, "prefill",
                                 cache=cache)
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
                                 "decode", cache=cache)
        return lm._unembed(cfg, params, h[:, -1:])[:, 0], cache

    return Model(cfg=cfg, init=init, logical_specs=logical,
                 prefill=prefill, decode=decode,
                 init_cache=functools.partial(_cache_struct, cfg))


def param_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(total, active) parameter counts from the init shapes, built on
    ``torch.device("meta")``: nothing is allocated."""
    params, _ = lm.init_params(cfg, device="meta")
    total = 0
    stack = [params]
    while stack:
        for v in stack.pop().values():
            if isinstance(v, dict):
                stack.append(v)
            else:
                total += v.numel()
    return total, total
