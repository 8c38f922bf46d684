"""Explicit all-to-all MoE dispatch over an expert mesh (counterpart of
``repro.models.moe_a2a``).

Per token shard: route the shard's own tokens into (E, C_l, d) send
buckets with a per-shard capacity ``C_l = ceil(T_l * k / E * cf)``, an
all-to-all over the expert axes -> (E_l, n_e * C_l, d), the shard's
E / n_e experts (optionally tensor-parallel on d_ff, the token outputs
then summed over ``tp``), the all-to-all back, and the gates combined
locally; the load-balance loss is averaged over the token shards.

The per-shard body (:func:`_shard_body`) is written once, over a leading
axis of shards, and runs on two backends:

* a ``launch.mesh.LocalMesh`` with axes past 1: every shard on the one
  device, stacked on that leading axis (as ``dist.graph_engine`` stacks
  its shards); an all-to-all is a transpose of the stacked chunks, a
  ``psum`` / ``pmean`` a sum / mean over the axis (:class:`_Stacked`);
* the dry run's ``DeviceMesh`` (``launch.mesh.make_placeholder_mesh``):
  the body runs on each rank's local tensors (a leading axis of 1) under
  ``local_map``, with functional collectives that ``launch.costs``
  counts (:class:`_Functional`).

Used (``models.lm.moe_apply``) when a sharding-rules context with a mesh
is active and the expert weights carry no FSDP dim (serving); falls back
to the dense ``layers.moe_ffn`` otherwise, and where JAX's does: one
expert shard, E not divisible by the expert shards, or a batch that does
not divide them when the tokens are on the expert axes.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from ..dist.local_ops import moe_dense
from ..dist.sharding import is_device_mesh, mesh_sizes, placements_for
from . import layers as L

__all__ = ["moe_ffn_a2a", "a2a_plan"]


def _axes_tuple(ax) -> Tuple[str, ...]:
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


def a2a_plan(B: int, S: int, E: int, f: int, *, top_k: int,
             capacity_factor: float, mesh, token_axes, expert_axes,
             tp_axis: Optional[str]):
    """JAX's static choices for a call: None where it falls back to the
    dense dispatch, else ``dict(tok, exp, tp, n_e, n_tok, batch_ok, T_l,
    C_l)`` (``tp`` None unless d_ff splits over it and it is neither a
    token nor an expert axis)."""
    sizes = mesh_sizes(mesh)
    tok, exp = _axes_tuple(token_axes), _axes_tuple(expert_axes)
    n_e = math.prod(sizes[a] for a in exp) if exp else 1
    if n_e == 1 or E % n_e != 0 or (B % n_e != 0 and tok == exp):
        return None
    tp = tp_axis if (tp_axis and tp_axis in sizes and
                     f % sizes[tp_axis] == 0 and tp_axis not in exp and
                     tp_axis not in tok) else None
    n_tok = math.prod(sizes[a] for a in tok) if tok else 1
    batch_ok = B % n_tok == 0 if tok else True
    T_l = (B // n_tok if B % n_tok == 0 else B) * S
    C_l = max(1, int(math.ceil(T_l * top_k / E * capacity_factor)))
    return dict(tok=tok, exp=exp, tp=tp, n_e=n_e, n_tok=n_tok,
                batch_ok=batch_ok, T_l=T_l, C_l=C_l)


def _shard_body(xl, rw, w1l, w3l, w2l, *, top_k: int, C_l: int, dtype,
                comm, exp: Sequence[str], tok: Sequence[str],
                tp: Optional[str]):
    """One program per shard, over a leading axis of D shards: xl (D, Bl,
    Sl, d), rw (D, d, E), w1l / w3l (D, E_l, d, f_l), w2l (D, E_l, f_l,
    d). Returns (out (D, Bl, Sl, d), aux (D,)) and the routing (``r``,
    for the gates of ``chip_smoke.py``)."""
    D, Bl, Sl, d = xl.shape
    E = rw.shape[-1]
    Tl = Bl * Sl
    xf = xl.reshape(D, Tl, d)
    logits = torch.matmul(xf.float(), rw.float())             # (D, Tl, E)
    r = L.moe_route(logits, top_k, C_l)
    send = L.moe_dispatch(xf, r, E, C_l, dtype)           # (D, E, C_l, d)
    # dispatch: split the experts across shards, concat token slices
    recv = send
    for a in exp:
        recv = comm.all_to_all(recv, a, split_axis=1, concat_axis=2)
    y = L.moe_experts(recv, w1l, w3l, w2l, dtype)   # (D, E_l, n_e*C_l, d)
    # return path (y is f-partial under tp; summed after the combine)
    back = y
    for a in reversed(exp):
        back = comm.all_to_all(back, a, split_axis=2, concat_axis=1)
    out = L.moe_combine(back.reshape(D, E * C_l, d), r, Tl, dtype)
    if tp is not None:
        out = comm.psum(out, tp)
    aux = L._load_balance_loss(logits, r["gidx"], E)          # (D,)
    if tok:
        aux = comm.pmean(aux, tok)
    return out.reshape(D, Bl, Sl, d), aux, r


class _Stacked:
    """Collectives over shards stacked on a leading axis of D = the mesh's
    size (row-major over its axes) on one device."""

    def __init__(self, sizes):
        self.names = list(sizes)
        self.sizes = [sizes[a] for a in self.names]

    def _grid(self, t):
        return t.reshape(tuple(self.sizes) + tuple(t.shape[1:]))

    def _flat(self, g):
        return g.reshape((-1,) + tuple(g.shape[len(self.sizes):]))

    def all_to_all(self, t, axis: str, split_axis: int, concat_axis: int):
        """``jax.lax.all_to_all(tiled=True)`` over mesh axis ``axis``:
        shard i's chunk j of ``split_axis`` goes to shard j, which
        concatenates the chunks it receives along ``concat_axis`` in
        the senders' order."""
        k, ai = len(self.sizes), self.names.index(axis)
        n = self.sizes[ai]
        # (n_src, the other k - 1 axes, per-shard dims); split / concat
        # count the leading shard axis of t
        g = self._grid(t).movedim(ai, 0)
        s = k - 1 + split_axis
        g = g.unflatten(s, (n, g.shape[s] // n))        # split -> (dst, m)
        # dst first (the concat dim is then at k + concat_axis), src just
        # before the concat dim and merged into it: one copy
        c = k - 1 + concat_axis
        g = g.movedim(s, 0).movedim(1, c).flatten(c, c + 1)
        return self._flat(g.movedim(0, ai))

    def psum(self, t, axis: str):
        ai = self.names.index(axis)
        g = self._grid(t)
        return self._flat(g.sum(dim=ai, keepdim=True).expand(g.shape))

    def pmean(self, t, axes: Sequence[str]):
        dims = [self.names.index(a) for a in axes]
        g = self._grid(t)
        return self._flat(g.mean(dim=dims, keepdim=True).expand(g.shape))


class _Functional:
    """Collectives of one rank's local tensors (a leading axis of 1) on a
    ``DeviceMesh``: ``torch.distributed`` functional collectives over the
    mesh axis's group (on the dry run's fake group they send nothing and
    are counted by ``launch.costs``)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def all_to_all(self, t, axis: str, split_axis: int, concat_axis: int):
        import torch.distributed._functional_collectives as funcol
        n = self.mesh.size(list(self.mesh.mesh_dim_names).index(axis))
        u = t[0].movedim(split_axis - 1, 0).contiguous()
        r = funcol.all_to_all_single(u, None, None,
                                     self.mesh.get_group(axis))
        r = r.reshape((n, u.shape[0] // n) + tuple(u.shape[1:]))
        r = r.movedim(1, split_axis)            # (n_src, chunk layout)
        r = r.movedim(0, concat_axis - 1)
        return r.flatten(concat_axis - 1, concat_axis)[None]

    def psum(self, t, axis: str):
        import torch.distributed._functional_collectives as funcol
        return funcol.all_reduce(t, "sum", self.mesh.get_group(axis))

    def pmean(self, t, axes: Sequence[str]):
        import torch.distributed._functional_collectives as funcol
        names = list(self.mesh.mesh_dim_names)
        n = 1
        for a in axes:
            t = funcol.all_reduce(t, "sum", self.mesh.get_group(a))
            n *= self.mesh.size(names.index(a))
        return t / n


def _stack(t, dim_axes, sizes):
    """Shards of ``t`` stacked on a leading axis over every device of the
    mesh (row-major): ``dim_axes[d]`` lists the mesh axes that dim ``d``
    is split over (outermost first); the tensor is repeated (a broadcast
    view where it can be) over the other axes. -> (D, *local shape)."""
    names = list(sizes)
    split_shape, src_pos = [], {}
    for d, axes in enumerate(dim_axes):
        for a in axes:
            src_pos[a] = len(split_shape)
            split_shape.append(sizes[a])
        n = math.prod(sizes[a] for a in axes)
        split_shape.append(t.shape[d] // n)
    local_dims = [i for i in range(len(split_shape))
                  if i not in src_pos.values()]
    g = t.reshape(split_shape)
    lead = [src_pos[a] for a in names if a in src_pos]
    g = g.permute(lead + local_dims)
    # insert the unused axes as broadcast dims, in the mesh's order
    for i, a in enumerate(names):
        if a not in src_pos:
            g = g.unsqueeze(i)
    g = g.expand(tuple(sizes[a] for a in names) +
                 tuple(g.shape[len(names):]))
    return g.reshape((-1,) + tuple(g.shape[len(names):]))


def _unstack(t, dim_axes, sizes):
    """The inverse of :func:`_stack` for an output: (D, *local) -> the
    whole tensor, taking the first shard along every axis it is not
    split over (the shards agree there)."""
    names = list(sizes)
    g = t.reshape(tuple(sizes[a] for a in names) + tuple(t.shape[1:]))
    k = len(names)
    used = [a for axes in dim_axes for a in axes]
    for i in reversed(range(k)):
        if names[i] not in used:
            g = g.narrow(i, 0, 1)
    # move each split axis next to its dim, outermost first, and merge
    out_shape = []
    perm = []
    for d, axes in enumerate(dim_axes):
        perm += [names.index(a) for a in axes] + [k + d]
        out_shape.append(g.shape[k + d] * math.prod(sizes[a] for a in axes))
    rest = [i for i in range(k) if names[i] not in used]
    return g.permute(rest + perm).reshape(out_shape)


def moe_ffn_a2a(x, router_w, w1, w3, w2, *, top_k: int,
                capacity_factor: float, dtype, mesh, token_axes,
                expert_axes, tp_axis: Optional[str], return_routing=False):
    """x: (B, S, d) batch-sharded on ``token_axes``; w1 / w3: (E, d, f),
    w2: (E, f, d) with E sharded on ``expert_axes`` and optionally f on
    ``tp_axis``. Returns (y (B, S, d), aux) as JAX's ``moe_ffn_a2a``;
    with ``return_routing`` (stacked mesh only) also each shard's
    ``moe_route`` dict (leading axis: the mesh's devices, row-major)."""
    B, S, d = x.shape
    E, f = router_w.shape[1], w1.shape[-1]
    plan = a2a_plan(B, S, E, f, top_k=top_k,
                    capacity_factor=capacity_factor, mesh=mesh,
                    token_axes=token_axes, expert_axes=expert_axes,
                    tp_axis=tp_axis)
    if plan is None:
        out = moe_dense(x, router_w, w1, w3, w2, top_k=top_k,
                        capacity_factor=capacity_factor, dtype=dtype)
        return out + (None,) if return_routing else out
    tok, exp, tp = plan["tok"], plan["exp"], plan["tp"]
    x_axes = [tok if plan["batch_ok"] and tok else (), (), ()]
    w_axes = [exp, (), (tp,) if tp else ()]
    w2_axes = [exp, (tp,) if tp else (), ()]
    kw = dict(top_k=top_k, C_l=plan["C_l"], dtype=dtype, exp=exp, tok=tok,
              tp=tp)
    if is_device_mesh(mesh):
        return _on_device_mesh(x, router_w, w1, w3, w2, mesh, x_axes,
                               w_axes, w2_axes, kw)
    sizes = mesh_sizes(mesh)
    out, aux, r = _shard_body(
        _stack(x, x_axes, sizes), _stack(router_w, [(), ()], sizes),
        _stack(w1, w_axes, sizes), _stack(w3, w_axes, sizes),
        _stack(w2, w2_axes, sizes), comm=_Stacked(sizes), **kw)
    y = _unstack(out, x_axes, sizes)
    return (y, aux[0], r) if return_routing else (y, aux[0])


def _on_device_mesh(x, router_w, w1, w3, w2, mesh, x_axes, w_axes, w2_axes,
                    kw):
    """The body under ``local_map`` on a ``DeviceMesh``: each rank's
    local tensors in, its local output and the (replicated) aux out."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    def spec(axes):
        return placements_for([a or None for a in axes], mesh)

    comm = _Functional(mesh)

    def local(xl, rw, w1l, w3l, w2l):
        out, aux, _ = _shard_body(xl[None], rw[None], w1l[None], w3l[None],
                                  w2l[None], comm=comm, **kw)
        return out[0], aux[0]

    repl = [Replicate()] * mesh.ndim
    fn = local_map(local, out_placements=(spec(x_axes), repl),
                   in_placements=(spec(x_axes), repl, spec(w_axes),
                                  spec(w_axes), spec(w2_axes)),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(x, router_w, w1, w3, w2)
