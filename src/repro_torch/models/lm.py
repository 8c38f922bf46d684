"""LM assembly of the port for every family: dense / vlm / moe / ssm /
hybrid / encdec (counterpart of ``repro.models.lm``).

* params are plain dicts; per-layer tensors are stacked on a leading L
  dim (the hybrid family's on (groups, per unit)), as in the JAX package,
  and the layers run as a Python loop over that dim (no remat: the port
  serves, it does not train yet);
* a parallel *logical spec* tree is returned beside the params;
* three entry modes share the block code: 'train' (no cache), 'prefill'
  (build the cache), 'decode' (one token against the cache). The cache
  tree (``models.api._cache_struct``) is updated in place, every leaf
  (K/V rows, cache lengths, SSM states, conv tails) written into the
  views it was given, and returned: the JAX engine donates it to its
  decode, and the port's engine serves a slot from views of its rows.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from . import layers as L
from . import rglru as RG
from . import ssm as SSM
from .config import ModelConfig

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")
# leaves that are float32 whatever ``param_dtype`` says (as in the JAX init)
FLOAT32_LEAVES = ("router", "A_log", "D", "dt_bias", "lam")


def check_family(cfg: ModelConfig):
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)


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
    ``device="meta"``) the shapes alone. Every leaf is in ``cfg.pdt`` but
    ``FLOAT32_LEAVES``; the hybrid family's leaves are drawn stacked over
    (groups x per unit) layers, then reshaped to (groups, per unit, ...)."""
    check_family(cfg)
    if generator is not None:
        device = generator.device
    dt = cfg.pdt
    d, f, V, hd = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.hd
    Hq, Hkv = cfg.n_heads, cfg.kv_heads
    f32 = torch.float32

    def dense(shp, spec, scale=None, dtype=dt):
        return L.dense_init(generator, shp, dtype, spec, scale, device)

    def const(shp, value, spec, dtype=dt):
        return torch.full(shp, value, dtype=dtype, device=device), spec

    def attn_block(Lc):
        p = {
            "ln1": const((Lc, d), 1.0, ("layers", "embed")),
            "wq": dense((Lc, d, Hq * hd), ("layers", "fsdp", "tp")),
            "wk": dense((Lc, d, Hkv * hd), ("layers", "fsdp", "kv_tp")),
            "wv": dense((Lc, d, Hkv * hd), ("layers", "fsdp", "kv_tp")),
            "wo": dense((Lc, Hq * hd, d), ("layers", "tp", "fsdp")),
        }
        if cfg.qkv_bias:
            p["bq"] = const((Lc, Hq * hd), 0.0, ("layers", "tp"))
            p["bk"] = const((Lc, Hkv * hd), 0.0, ("layers", "kv_tp"))
            p["bv"] = const((Lc, Hkv * hd), 0.0, ("layers", "kv_tp"))
        return p

    def mlp_block(Lc, ff=f):
        p = {"ln2": const((Lc, d), 1.0, ("layers", "embed")),
             "w1": dense((Lc, d, ff), ("layers", "fsdp", "tp"))}
        if cfg.act == "swiglu":
            p["w3"] = dense((Lc, d, ff), ("layers", "fsdp", "tp"))
        p["w2"] = dense((Lc, ff, d), ("layers", "tp", "fsdp"))
        return p

    tree: Dict[str, Any] = {
        "embed": dense((V, d), ("vocab", "fsdp"), scale=0.02),
        "final_ln": const((d,), 1.0, ("embed",)),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = dense((d, V), ("fsdp", "vocab"))

    Lc = cfg.layers
    if cfg.family in ("dense", "vlm"):
        tree["layers"] = {**attn_block(Lc), **mlp_block(Lc)}
    elif cfg.family == "moe":
        E = cfg.n_experts
        tree["layers"] = {
            **attn_block(Lc),
            "ln2": const((Lc, d), 1.0, ("layers", "embed")),
            "router": dense((Lc, d, E), ("layers", "embed", None),
                            dtype=f32),
            "we1": dense((Lc, E, d, f), ("layers", "experts", "fsdp", "tp")),
            "we3": dense((Lc, E, d, f), ("layers", "experts", "fsdp", "tp")),
            "we2": dense((Lc, E, f, d), ("layers", "experts", "tp", "fsdp")),
        }
    elif cfg.family == "ssm":
        din = cfg.ssm_expand * d
        N = cfg.ssm_state
        H = cfg.ssm_heads or (din // cfg.ssm_head_dim)
        conv_dim = din + 2 * N
        dproj = 2 * din + 2 * N + H
        tree["layers"] = {
            "ln": const((Lc, d), 1.0, ("layers", "embed")),
            "in_proj": dense((Lc, d, dproj), ("layers", "fsdp", "tp")),
            "conv_w": dense((Lc, cfg.conv_width, conv_dim),
                            ("layers", None, "tp"), scale=0.5),
            "A_log": const((Lc, H), 0.0, ("layers", "heads"), f32),
            "D": const((Lc, H), 1.0, ("layers", "heads"), f32),
            "dt_bias": const((Lc, H), 0.0, ("layers", "heads"), f32),
            "gnorm": const((Lc, din), 1.0, ("layers", "tp")),
            "out_proj": dense((Lc, din, d), ("layers", "tp", "fsdp")),
        }
    elif cfg.family == "hybrid":
        unit = len(cfg.pattern)
        groups = cfg.layers // unit
        rest = cfg.layers - groups * unit
        Dr = cfg.lru_width or d
        rec_per_unit = sum(1 for t in cfg.pattern if t == "rec")
        att_per_unit = unit - rec_per_unit

        def rec_block(n):
            return {
                "ln": const((n, d), 1.0, ("layers", "embed")),
                "wx": dense((n, d, Dr), ("layers", "fsdp", "tp")),
                "wg": dense((n, d, Dr), ("layers", "fsdp", "tp")),
                "conv_w": dense((n, cfg.conv_width, Dr),
                                ("layers", None, "tp"), scale=0.5),
                "wr": dense((n, Dr, Dr), ("layers", "tp_in", "tp")),
                "wi": dense((n, Dr, Dr), ("layers", "tp_in", "tp")),
                "lam": const((n, Dr), 0.5, ("layers", "tp"), f32),
                "wo": dense((n, Dr, d), ("layers", "tp", "fsdp")),
            }

        def grouped(block, per):
            return {k: (v.reshape((groups, per) + v.shape[1:]),
                        ("layers", "unit") + s[1:])
                    for k, (v, s) in block(groups * per).items()}

        tree["groups"] = {
            "rec": grouped(rec_block, rec_per_unit),
            "attn": grouped(attn_block, att_per_unit),
            "mlp": grouped(mlp_block, unit),
        }
        if rest:
            tree["tail"] = {"rec": rec_block(rest), "mlp": mlp_block(rest)}
    else:   # encdec
        tree["enc_layers"] = {**attn_block(cfg.enc_layers),
                              **mlp_block(cfg.enc_layers)}
        dec = attn_block(cfg.dec_layers)
        cross = {f"x{k}": v for k, v in attn_block(cfg.dec_layers).items()}
        tree["dec_layers"] = {**dec, **cross, **mlp_block(cfg.dec_layers)}
        tree["enc_final_ln"] = const((d,), 1.0, ("embed",))
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


def moe_apply(cfg, p, x):
    """The MoE FFN of a layer through ``layers.moe_ffn`` (the JAX
    package's dense dispatch). Its all-to-all dispatch over an expert
    mesh (``repro.models.moe_a2a``) needs a mesh context the port does not
    have yet: ROADMAP Queue 1 item 4, with ``dist/sharding.py``."""
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    y, aux = L.moe_ffn(h, p["router"], p["we1"], p["we3"], p["we2"],
                       top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                       dtype=cfg.cdt)
    return y.to(x.dtype), aux


def ssm_apply(cfg, p, x, mode, cache):
    """Mamba2 block. cache = SSMCache (read, not written) or None; returns
    (y, new SSMCache or None)."""
    B, S, d = x.shape
    din = cfg.ssm_expand * d
    N = cfg.ssm_state
    H = cfg.ssm_heads or (din // cfg.ssm_head_dim)
    P_ = din // H
    h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    zxbcdt = L.mm(h, p["in_proj"])
    z, xs, Bc, Cc, dt = torch.split(zxbcdt, [din, din, N, N, H], dim=-1)
    conv_in = torch.cat([xs, Bc, Cc], dim=-1)
    conv_cache = None if cache is None else cache.conv
    conv_out, new_conv = SSM.causal_conv(conv_in, p["conv_w"], conv_cache)
    xs, Bc, Cc = torch.split(conv_out, [din, N, N], dim=-1)
    dt = L.softplus(dt.float() + p["dt_bias"][None, None])
    A = -torch.exp(p["A_log"].float())
    xh = xs.reshape(B, S, H, P_)
    if mode == "decode":
        y, h_new = SSM.ssd_decode_step(xh[:, 0], dt[:, 0], A, Bc[:, 0],
                                       Cc[:, 0], p["D"], cache.h)
        y = y[:, None]
        new_cache = SSM.SSMCache(h=h_new, conv=new_conv)
    else:
        y, h_final = SSM.ssd_chunked(xh, dt, A, Bc, Cc, p["D"],
                                     chunk=cfg.ssm_chunk)
        new_cache = SSM.SSMCache(h=h_final, conv=new_conv) \
            if mode == "prefill" else None
    y = y.reshape(B, S, din)
    y = L.rmsnorm(y * L.silu(z), p["gnorm"], cfg.norm_eps)
    return L.mm(y, p["out_proj"]).to(x.dtype), new_cache


def rec_apply(cfg, p, x, mode, cache):
    """RG-LRU recurrent block. cache = (h, conv) (read, not written) or
    None; returns (y, new (h, conv) or None)."""
    h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    u = L.mm(h, p["wx"])
    g = L.gelu(L.mm(h, p["wg"]))
    conv_cache = None if cache is None else cache[1]
    u, new_conv = SSM.causal_conv(u, p["conv_w"], conv_cache)
    r = L.mm(u, p["wr"])
    i = L.mm(u, p["wi"])
    if mode == "decode":
        y, h_new = RG.rglru_step(u[:, 0], r[:, 0], i[:, 0], p["lam"],
                                 cache[0])
        y = y[:, None]
        new_cache = (h_new, new_conv)
    else:
        y, h_last = RG.rglru_scan(u, r, i, p["lam"])
        new_cache = (h_last, new_conv) if mode == "prefill" else None
    return L.mm(y * g, p["wo"]).to(x.dtype), new_cache


def _store(views, new):
    """Write a block's new cache leaves into the cache views it read."""
    for v, n in zip(views, new):
        v.copy_(n)


def _at(stacked, *idx):
    """The params of one layer: ``stacked[k][idx]`` for every leaf."""
    return {k: v[idx] for k, v in stacked.items()}


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


def _attn_layer(cfg, p, x, pos, mode, cache, idx, window, causal=True):
    """``attn_apply`` on the views ``cache[j][idx]``; k and v are written
    in place, the cache length here."""
    c = None if cache is None else tuple(t[idx] for t in cache)
    a, nc = attn_apply(cfg, p, x, pos, mode, c, causal=causal, window=window)
    if nc is not None:
        cache[2][idx] = nc[2]
    return a


def _rec_layer(cfg, p, x, mode, cache, idx):
    """``rec_apply`` on the views ``(h[idx], conv[idx])``, its new state
    copied into them."""
    c = None if cache is None else (cache[0][idx], cache[1][idx])
    y, nc = rec_apply(cfg, p, x, mode, c)
    if nc is not None:
        _store(c, nc)
    return y


def forward(cfg: ModelConfig, params, tokens, pos, mode: str, cache=None,
            enc_out=None):
    """Shared trunk -> final hidden states (B, S, d). Returns
    (h, cache, aux): ``cache`` updated in place (None in 'train'), ``aux``
    the MoE balance loss averaged over layers (0 for the other families).
    ``enc_out`` (B, S_enc, d): the encoder's states, for ``encdec``."""
    check_family(cfg)
    x = _embed(cfg, params, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    if cfg.family in ("dense", "vlm", "moe"):
        stacked = params["layers"]
        for i in range(cfg.layers):
            p = _at(stacked, i)
            a = _attn_layer(cfg, p, x, pos, mode, cache, i, cfg.window)
            x = constrain(x + a, "batch", "act_seq", None)
            if cfg.family == "moe":
                m, la = moe_apply(cfg, p, x)
                aux = aux + la
            else:
                m = mlp_apply(cfg, p, x)
            x = constrain(x + m, "batch", "act_seq", None)
        return x, cache, aux / max(cfg.layers, 1)

    if cfg.family == "ssm":
        stacked = params["layers"]
        for i in range(cfg.layers):
            c = None if cache is None else SSM.SSMCache(cache.h[i],
                                                        cache.conv[i])
            y, nc = ssm_apply(cfg, _at(stacked, i), x, mode, c)
            if nc is not None:
                _store(c, nc)
            x = constrain(x + y, "batch", "act_seq", None)
        return x, cache, aux

    if cfg.family == "hybrid":
        unit = len(cfg.pattern)
        groups = cfg.layers // unit
        g_cache, t_cache = cache if cache is not None else (None, None)
        rec_c, att_c = g_cache if g_cache is not None else (None, None)
        gp = params["groups"]
        for g in range(groups):
            ri = ai = 0
            for j, t in enumerate(cfg.pattern):
                if t == "rec":
                    y = _rec_layer(cfg, _at(gp["rec"], g, ri), x, mode,
                                   rec_c, (g, ri))
                    ri += 1
                else:
                    y = _attn_layer(cfg, _at(gp["attn"], g, ai), x, pos,
                                    mode, att_c, (g, ai), cfg.window)
                    ai += 1
                x = x + y
                x = x + mlp_apply(cfg, _at(gp["mlp"], g, j), x)
                x = constrain(x, "batch", "act_seq", None)
        if "tail" in params:
            tp = params["tail"]
            for j in range(cfg.layers - groups * unit):
                x = x + _rec_layer(cfg, _at(tp["rec"], j), x, mode, t_cache,
                                   j)
                x = x + mlp_apply(cfg, _at(tp["mlp"], j), x)
        return x, cache, aux

    # encdec: tokens are the decoder's; enc_out the encoder's states
    stacked = params["dec_layers"]
    for i in range(cfg.dec_layers):
        p = _at(stacked, i)
        self_p = {k: p[k] for k in ("ln1", "wq", "wk", "wv", "wo") if k in p}
        x = x + _attn_layer(cfg, self_p, x, pos, mode, cache, i, None)
        x = x + _cross_attn(cfg, {k[1:]: v for k, v in p.items()
                                  if k.startswith("x")}, x, enc_out)
        x = constrain(x + mlp_apply(cfg, p, x), "batch", "act_seq", None)
    return x, cache, aux


def _cross_attn(cfg, p, x, enc_out):
    B, S = x.shape[:2]
    Se = enc_out.shape[1]
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    q = L.mm(h, p["wq"]).reshape(B, S, cfg.n_heads, cfg.hd)
    k = L.mm(enc_out, p["wk"]).reshape(B, Se, cfg.kv_heads, cfg.hd)
    v = L.mm(enc_out, p["wv"]).reshape(B, Se, cfg.kv_heads, cfg.hd)
    o = L.flash_attention(q, k, v, causal=False, q_chunk=cfg.q_chunk,
                          kv_chunk=cfg.kv_chunk)
    return L.mm(o.reshape(B, S, cfg.n_heads * cfg.hd), p["wo"]).to(x.dtype)


def encode(cfg: ModelConfig, params, frames):
    """Whisper encoder over stub frame embeddings (B, S, d)."""
    x = frames.to(cfg.cdt)
    pos = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    stacked = params["enc_layers"]
    for i in range(cfg.enc_layers):
        p = _at(stacked, i)
        a, _ = attn_apply(cfg, p, x, pos, "train", None, causal=False)
        x = x + a
        x = constrain(x + mlp_apply(cfg, p, x), "batch", "act_seq", None)
    return L.rmsnorm(x, params["enc_final_ln"], cfg.norm_eps)


def make_positions(cfg, tokens):
    B, S = tokens.shape[:2]
    p = torch.arange(S, dtype=torch.int32,
                     device=tokens.device).expand(B, S)
    if cfg.pos == "mrope":
        return torch.stack([p, p, p])  # text-only default; VLM feeds grids
    return p
