"""LM assembly of the port for the ``dense`` and ``vlm`` families
(counterpart of ``repro.models.lm``).

* params are plain dicts; per-layer tensors are stacked on a leading L
  dim, as in the JAX package, and the layers run as a Python loop over
  that dim (no remat: the port serves, it does not train yet);
* a parallel *logical spec* tree is returned beside the params;
* three entry modes share the block code: 'train' (no cache), 'prefill'
  (build the cache), 'decode' (one token against the cache). The cache
  ``(k, v, cache_len)`` with leaves ``(L, B, ...)`` is updated in place
  and returned: the JAX engine donates it to its decode.

The other families wait for their slices (ROADMAP Queue 1 item 4) and
raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from . import layers as L
from .config import ModelConfig

PORTED_FAMILIES = ("dense", "vlm")


def check_family(cfg: ModelConfig):
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.arch}) is not ported to "
            "repro_torch yet: ROADMAP.md Queue 1 item 4 (the LM stack) "
            "queues moe, ssm / hybrid and encdec after dense and vlm")


def constrain(x, *axes):
    """The identity: on one card there is no mesh to constrain ``x`` to
    (``repro.dist.sharding.constrain`` is a no-op without one too)."""
    return x


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator=None,
                device=None) -> Tuple[Dict, Dict]:
    """Returns (params, logical_specs), parallel dicts. Draws from
    ``generator`` on its device; with ``generator=None`` (only for
    ``device="meta"``) the shapes alone. Every leaf is in ``cfg.pdt``."""
    check_family(cfg)
    if generator is not None:
        device = generator.device
    dt = cfg.pdt
    d, f, V, hd = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.hd
    Hq, Hkv = cfg.n_heads, cfg.kv_heads

    def dense(shp, spec, scale=None):
        return L.dense_init(generator, shp, dt, spec, scale, device)

    def const(shp, value, spec):
        return torch.full(shp, value, dtype=dt, device=device), spec

    tree: Dict[str, Any] = {
        "embed": dense((V, d), ("vocab", "fsdp"), scale=0.02),
        "final_ln": const((d,), 1.0, ("embed",)),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = dense((d, V), ("fsdp", "vocab"))

    Lc = cfg.layers
    attn = {
        "ln1": const((Lc, d), 1.0, ("layers", "embed")),
        "wq": dense((Lc, d, Hq * hd), ("layers", "fsdp", "tp")),
        "wk": dense((Lc, d, Hkv * hd), ("layers", "fsdp", "kv_tp")),
        "wv": dense((Lc, d, Hkv * hd), ("layers", "fsdp", "kv_tp")),
        "wo": dense((Lc, Hq * hd, d), ("layers", "tp", "fsdp")),
    }
    if cfg.qkv_bias:
        attn["bq"] = const((Lc, Hq * hd), 0.0, ("layers", "tp"))
        attn["bk"] = const((Lc, Hkv * hd), 0.0, ("layers", "kv_tp"))
        attn["bv"] = const((Lc, Hkv * hd), 0.0, ("layers", "kv_tp"))
    mlp = {"ln2": const((Lc, d), 1.0, ("layers", "embed")),
           "w1": dense((Lc, d, f), ("layers", "fsdp", "tp"))}
    if cfg.act == "swiglu":
        mlp["w3"] = dense((Lc, d, f), ("layers", "fsdp", "tp"))
    mlp["w2"] = dense((Lc, f, d), ("layers", "tp", "fsdp"))
    tree["layers"] = {**attn, **mlp}
    return L.split_tree(tree)


# ---------------------------------------------------------------------------
# blocks (shared across modes)
# ---------------------------------------------------------------------------

def _project_qkv(cfg, p, x):
    q = L.mm(x, p["wq"])
    k = L.mm(x, p["wk"])
    v = L.mm(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    B, S = x.shape[:2]
    q = q.reshape(B, S, cfg.n_heads, cfg.hd)
    k = k.reshape(B, S, cfg.kv_heads, cfg.hd)
    v = v.reshape(B, S, cfg.kv_heads, cfg.hd)
    return q, k, v


def _pos_embed(cfg, q, k, pos):
    if cfg.pos == "mrope":
        q = L.apply_mrope(q, pos, cfg.rope_theta, cfg.mrope_sections)
        k = L.apply_mrope(k, pos, cfg.rope_theta, cfg.mrope_sections)
    elif cfg.pos == "rope":
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k = L.apply_rope(k, pos, cfg.rope_theta)
    return q, k


def _write_rows(c, slot, new):
    """``c[b, slot[b]] = new[b]`` for every row b whose slot is inside
    ``c``; a row with ``slot >= Smax`` is dropped, as JAX drops an
    out-of-range scatter (an idle engine slot's ``cache_len`` grows past
    ``smax``). No host sync: the dropped rows write their old value."""
    B, Smax = c.shape[:2]
    rows = torch.arange(B, device=c.device)
    keep = (slot < Smax)[:, None, None]
    idx = slot.clamp(max=Smax - 1)
    c[rows, idx] = torch.where(keep, new.to(c.dtype), c[rows, idx])


def attn_apply(cfg, p, x, pos, mode, cache, *, causal=True, window=None):
    """Returns (y, new_cache). cache = (k, v, cache_len) or None; its k and
    v are written in place."""
    B, S = x.shape[:2]
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(cfg, p, h)
    q, k = _pos_embed(cfg, q, k, pos)
    new_cache = None
    if mode == "train":
        o = L.flash_attention(q, k, v, causal=causal, window=window,
                              q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    elif mode == "prefill":
        kc, vc, _ = cache
        if window is not None and kc.shape[1] < S:  # ring cache (local attn)
            W = kc.shape[1]
            rot = S % W
            kc.copy_(torch.roll(k[:, -W:], rot, dims=1))
            vc.copy_(torch.roll(v[:, -W:], rot, dims=1))
        else:
            kc[:, :S] = k
            vc[:, :S] = v
        o = L.flash_attention(q, k, v, causal=causal, window=window,
                              q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
        new_cache = (kc, vc, torch.full((B,), S, dtype=torch.int32,
                                        device=x.device))
    else:  # decode
        kc, vc, clen = cache
        Smax = kc.shape[1]
        slot = (clen % Smax) if window is not None else clen
        _write_rows(kc, slot, k[:, 0])
        _write_rows(vc, slot, v[:, 0])
        if window is not None:
            # ring cache: every slot valid once warm; positions are implicit
            eff_len = torch.clamp_max(clen + 1, Smax)
            o = L.decode_attention(q, kc, vc, eff_len, window=None)
        else:
            o = L.decode_attention(q, kc, vc, clen + 1, window=None)
        new_cache = (kc, vc, clen + 1)
    o = o.reshape(B, S, cfg.n_heads * cfg.hd)
    return L.mm(o, p["wo"]).to(x.dtype), new_cache


def mlp_apply(cfg, p, x):
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    if cfg.act == "swiglu":
        return L.swiglu(h, p["w1"], p["w3"], p["w2"]).to(x.dtype)
    return L.gelu_mlp(h, p["w1"], p["w2"]).to(x.dtype)


# ---------------------------------------------------------------------------
# model application
# ---------------------------------------------------------------------------

def _embed(cfg, params, tokens):
    e = params["embed"][tokens]
    return constrain(e.to(cfg.cdt), "batch", "act_seq", None)


def _unembed(cfg, params, h):
    h = L.rmsnorm(h, params["final_ln"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (h @ w.to(h.dtype)).float()


def forward(cfg: ModelConfig, params, tokens, pos, mode: str, cache=None):
    """Shared trunk -> final hidden states (B, S, d). Returns
    (h, new_cache, aux); ``aux`` (the MoE balance loss) is 0 here."""
    check_family(cfg)
    x = _embed(cfg, params, tokens)
    stacked = params["layers"]
    for i in range(cfg.layers):
        p = {k: v[i] for k, v in stacked.items()}
        c = None if cache is None else tuple(t[i] for t in cache)
        a, nc = attn_apply(cfg, p, x, pos, mode, c, causal=True,
                           window=cfg.window)
        if nc is not None:
            cache[2][i] = nc[2]          # k and v were written in place
        x = constrain(x + a, "batch", "act_seq", None)
        x = constrain(x + mlp_apply(cfg, p, x), "batch", "act_seq", None)
    return x, cache, torch.zeros((), dtype=torch.float32, device=x.device)


def make_positions(cfg, tokens):
    B, S = tokens.shape[:2]
    p = torch.arange(S, dtype=torch.int32,
                     device=tokens.device).expand(B, S)
    if cfg.pos == "mrope":
        return torch.stack([p, p, p])  # text-only default; VLM feeds grids
    return p
