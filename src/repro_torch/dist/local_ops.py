"""The model's ops that DTensor cannot place as they are written, each
written for a ``DeviceMesh`` (the dry run's fake DTensors) the way XLA's
partitioner runs them: per rank on its local shards, with the collectives
that needs spelled out (and so counted by ``launch.costs``). On a plain
tensor each is the op itself, so the card's program is unchanged.

* :func:`split_last`: a head split of a projection whose shards do not
  divide the heads (8 KV heads over a model axis of 16) gathers the
  projection over those ranks first;
* :func:`merge_last`: the merge back, its gradient placed as the
  forward's output before the split of the backward;
* :func:`heads_local`: attention per rank on its batch rows and heads
  (``torch.distributed.tensor.experimental.local_map``); a rank whose
  query heads share one KV head that is not split over the ranks slices
  that head, as XLA's dynamic slice of a replicated operand;
* :func:`write_rows_local`: a cache row write (an advanced-index store)
  on each rank's rows;
* :func:`embed_rows`: a lookup in a table whose vocabulary is split
  over ranks, each rank looking up the ids in its range and the partial
  rows summed (the vocabulary-parallel embedding);
* :func:`xent_rows`: the cross-entropy of logits whose vocabulary is
  split over ranks from each rank's max, sum of exponentials and gold
  logit, three all-reduces of a value a row (DTensor would gather the
  logits), its backward local (the vocabulary-parallel loss).

:func:`place_like` gives a gradient its parameter's placements (a
reduce-scatter of a partial sum), as the JAX train step gives the
gradients the parameters' shardings.

A rank's coordinate comes from ``DeviceMesh.get_coordinate()``: the dry
run traces rank 0, which stands for every rank.
"""
from __future__ import annotations

import math

import torch

__all__ = ["is_dtensor", "split_last", "merge_last", "heads_local",
           "write_rows_local",
           "embed_rows", "xent_rows", "place_like"]


def is_dtensor(x) -> bool:
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _sdim(p, t):
    """The tensor dim a placement shards (non-negative), or None."""
    return p.dim % t.dim() if p.is_shard() else None


def _keep(t, dims):
    """``t``'s placements with only its shards of tensor ``dims`` kept."""
    from torch.distributed.tensor import Replicate
    return [p if _sdim(p, t) in dims else Replicate() for p in t.placements]


def _rank_along(mesh, mesh_dims) -> int:
    """This rank's index over ``mesh_dims``, row-major."""
    coord = mesh.get_coordinate()
    r = 0
    for i in mesh_dims:
        r = r * mesh.size(i) + coord[i]
    return r


def split_last(x, n: int, d: int):
    """x (..., n * d) -> (..., n, d). A DTensor whose last dim is split
    over mesh dims whose product does not divide ``n`` is gathered over
    them first."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate
        pl = list(x.placements)
        dims = [i for i, p in enumerate(pl) if _sdim(p, x) == x.dim() - 1]
        if n % math.prod(x.device_mesh.size(i) for i in dims):
            x = x.redistribute(x.device_mesh, [
                Replicate() if i in dims else p for i, p in enumerate(pl)])
    return x.reshape(*x.shape[:-1], n, d)


def merge_last(x):
    """x (..., n, d) -> (..., n * d). On a DTensor the gradient reaching
    the merge is placed as its output first, so that the split back
    keeps the placements the forward had."""
    y = x.flatten(-2)
    return _GradAs.apply(y) if is_dtensor(y) else y


class _GradAs(torch.autograd.Function):
    """Identity; the gradient is redistributed to the input's
    placements."""

    @staticmethod
    def forward(ctx, t):
        ctx.mesh, ctx.placements = t.device_mesh, tuple(t.placements)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.placements:
            grad = grad.redistribute(ctx.mesh, ctx.placements)
        return grad


def heads_local(fn, q, k, v, *rows, **kw):
    """``fn(q, k, v, *rows, **kw)`` (an attention: q (B, Sq, Hq, Dh), k /
    v (B, Skv, Hkv, Dh), each of ``rows`` (B, ...)) per rank on DTensors:
    q keeps its shards of the batch and head dims, k / v and ``rows``
    take q's batch shards, k / v its head shards where Hkv divides them,
    else whole, each rank then slicing the one KV head its query heads
    share. The output is placed as q."""
    if not is_dtensor(q):
        return fn(q, k, v, *rows, **kw)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    qp = _keep(q, (0, 2))
    bp = _keep(q, (0,))
    heads = [i for i, p in enumerate(qp) if _sdim(p, q) == 2]
    m = math.prod(mesh.size(i) for i in heads)
    Hq, Hkv = q.shape[2], k.shape[2]
    G, hq = Hq // Hkv, Hq // m
    lo = None
    if Hkv % m == 0:
        kvp = kvg = qp
    elif G % hq == 0:
        # whole on each rank, which uses one head: its gradient a partial
        # sum over the head ranks
        kvp = bp
        kvg = [Partial() if i in heads else p for i, p in enumerate(bp)]
        lo = _rank_along(mesh, heads) * hq // G
    else:
        raise ValueError(f"{Hq} query heads split {m} ways cannot pair "
                         f"with {Hkv} KV heads")

    def local(ql, kl, vl, *rl):
        if lo is not None:
            kl, vl = kl[:, :, lo:lo + 1], vl[:, :, lo:lo + 1]
        return fn(ql, kl, vl, *rl, **kw)

    rp = [bp if is_dtensor(r) else None for r in rows]
    return local_map(local, out_placements=qp,
                     in_placements=(qp, kvp, kvp, *rp),
                     in_grad_placements=(qp, kvg, kvg, *rp),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v,
                                                                 *rows)


def write_rows_local(fn, c, slot, new):
    """``fn(c, slot, new)`` (writes row ``slot[b]`` of ``c[b]`` from
    ``new[b]`` in place) per rank on a DTensor cache ``c`` (B, Smax, ...):
    ``slot`` (B,) and ``new`` (B, ...) are placed on ``c``'s rows and
    shards, and each rank writes its local rows."""
    if not is_dtensor(c):
        return fn(c, slot, new)
    from torch.distributed.tensor import Shard
    mesh = c.device_mesh
    cp = list(c.placements)
    if any(_sdim(p, c) == 1 for p in cp):
        raise ValueError("a cache split over its sequence dim")
    sp = _keep(c, (0,))
    npl = [Shard(_sdim(p, c) - 1) if _sdim(p, c) not in (None, 0) else p
           for p in cp]
    fn(c.to_local(), slot.redistribute(mesh, sp).to_local(),
       new.redistribute(mesh, npl).to_local())
    return c


def embed_rows(table, ids):
    """``table[ids]`` (table (V, d)); on a DTensor table whose vocabulary
    is split, each rank looks up the ids in its range and the rows are
    summed over those ranks (one all-reduce); the backward is local."""
    if not is_dtensor(table) or not any(
            _sdim(p, table) == 0 for p in table.placements):
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    tp = _keep(table, (0,))
    vd = [i for i, p in enumerate(tp) if p.is_shard()]
    if not is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    ip = [Replicate() if i in vd else p
          for i, p in enumerate(_keep(ids, (0,)))]
    # a group of one rank moves nothing
    groups = [mesh.get_group(i) for i in vd if mesh.size(i) > 1]
    lo = _rank_along(mesh, vd) * table.shape[0] // \
        math.prod(mesh.size(i) for i in vd)
    # the table's gradient: partial over the ranks that hold other rows
    # of the batch
    tg = [Partial() if ip[i].is_shard() else p for i, p in enumerate(tp)]
    return local_map(
        lambda t, i: _VocabEmbed.apply(t, i, lo, groups), out_placements=ip,
        in_placements=(tp, ip), in_grad_placements=(tg, ip),
        device_mesh=mesh, redistribute_inputs=True)(table, ids)


class _VocabEmbed(torch.autograd.Function):
    """One rank's part of a lookup in a table split by vocabulary: t (V_l,
    d) the rank's rows, ids of the whole vocabulary, ``lo`` the rank's
    first id; the rows summed over ``groups``."""

    @staticmethod
    def forward(ctx, t, ids, lo, groups):
        n = t.shape[0]
        inside = (ids >= lo) & (ids < lo + n)
        local = (ids - lo).clamp(0, n - 1)
        rows = torch.where(inside[..., None], t[local], torch.zeros(
            (), dtype=t.dtype, device=t.device))
        ctx.save_for_backward(inside, local)
        ctx.shape = t.shape
        return _all_reduce(rows, "sum", groups)

    @staticmethod
    def backward(ctx, grad):
        inside, local = ctx.saved_tensors
        g = torch.zeros(ctx.shape, dtype=grad.dtype, device=grad.device)
        g.index_put_((local,), torch.where(inside[..., None], grad, 0.0),
                     accumulate=True)
        return g, None, None, None


def xent_rows(logits, ids):
    """``logsumexp(logits, -1) - logits[..., ids]`` (logits (B, S, V), ids
    (B, S) in range); see the module docstring for a DTensor whose last
    dim is split."""
    if not is_dtensor(logits) or not any(
            _sdim(p, logits) == 2 for p in logits.placements):
        return torch.logsumexp(logits, dim=-1) - torch.take_along_dim(
            logits, ids[..., None], dim=-1)[..., 0]
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    lp = _keep(logits, (0, 2))
    vd = [i for i, p in enumerate(lp) if _sdim(p, logits) == 2]
    bp = [Shard(0) if _sdim(p, logits) == 0 else Replicate() for p in lp]
    if not is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    # a group of one rank moves nothing
    groups = [mesh.get_group(i) for i in vd if mesh.size(i) > 1]
    lo = _rank_along(mesh, vd) * logits.shape[2] // \
        math.prod(mesh.size(i) for i in vd)
    return local_map(
        lambda t, i: _VocabXent.apply(t, i, lo, groups), out_placements=bp,
        in_placements=(lp, bp), device_mesh=mesh,
        redistribute_inputs=True)(logits, ids)


def _all_reduce(t, op, groups):
    import torch.distributed._functional_collectives as funcol
    for g in groups:
        t = funcol.wait_tensor(funcol.all_reduce(t, op, g))
    return t


class _VocabXent(torch.autograd.Function):
    """One rank's part of the cross-entropy over a split vocabulary: t
    (B, S, V_l) the rank's logits, ids of the whole vocabulary, ``lo``
    the rank's first id."""

    @staticmethod
    def forward(ctx, t, ids, lo, groups):
        n = t.shape[-1]
        m = _all_reduce(t.amax(dim=-1), "max", groups)
        e = torch.exp(t - m[..., None])
        s = _all_reduce(e.sum(dim=-1), "sum", groups)
        inside = (ids >= lo) & (ids < lo + n)
        local = (ids - lo).clamp(0, n - 1)
        g = torch.take_along_dim(t, local[..., None], dim=-1)[..., 0]
        g = _all_reduce(torch.where(inside, g, torch.zeros_like(g)), "sum",
                        groups)
        ctx.save_for_backward(e, s, inside, local)
        return m + torch.log(s) - g

    @staticmethod
    def backward(ctx, grad):
        e, s, inside, local = ctx.saved_tensors
        d = e / s[..., None]
        d.scatter_add_(-1, local[..., None],
                       -inside[..., None].to(d.dtype))
        return d * grad[..., None], None, None, None


def place_like(t, ref):
    """``t`` placed as ``ref`` where both are DTensors; else ``t``."""
    if is_dtensor(t) and is_dtensor(ref) and \
            tuple(t.placements) != tuple(ref.placements):
        return t.redistribute(ref.device_mesh, ref.placements)
    return t
