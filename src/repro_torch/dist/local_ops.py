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
* :func:`embed_rows`: a lookup per rank in its batch rows, in a table
  whose vocabulary is split over ranks the ids in its range and the
  partial rows summed (the vocabulary-parallel embedding);
* :func:`xent_rows`: the cross-entropy of logits whose vocabulary is
  split over ranks from each rank's max, sum of exponentials and gold
  logit, three all-reduces of a value a row (DTensor would gather the
  logits), its backward local (the vocabulary-parallel loss);
* :func:`moe_dense`: the dense MoE dispatch over every token of the
  batch (``layers.moe_ffn``: one stable sort of all pairs, one global
  capacity), each rank routing its own tokens and ranking its pairs
  after those of the token ranks before it (one all-gather of a count
  an expert), the capacity buffers summed over the token ranks;
* :func:`ssd_local`: the SSD chunk scan and its decode step on each
  rank's batch rows and heads;
* :func:`rglru_local`: the RG-LRU scan and step on each rank's batch
  rows and channels;
* :func:`roll_local`: a roll along a dim that each rank holds whole
  (the local-attention ring cache);
* :func:`layer_of` / :func:`set_layer`: a layer's view of a stacked
  cache leaf read and written back where the layer dims are split over
  ranks (JAX's cache rule splits a recurrent state's leading dim: each
  rank holds some layers), the owner's block summed to every rank and
  the new state gathered to the owner;
* :func:`reduced`, :func:`mean_last`: a partial sum reduced before a
  norm reads its rows (the all-reduce of a row-parallel projection added
  to the residual), and a norm's mean over a row split over ranks, an
  all-reduce of each rank's sum (DTensor would reduce-scatter either
  onto the sequence, and its own matmul cannot take the strided shard
  that a later flatten makes of it).

:func:`place_like` gives a gradient its parameter's placements (a
reduce-scatter of a partial sum), as the JAX train step gives the
gradients the parameters' shardings; :func:`grad_placed` does so for
each use of a parameter used twice. Batch rows are the active rules'
``batch`` axis (``dist.sharding``).

A rank's coordinate comes from ``DeviceMesh.get_coordinate()``: the dry
run traces rank 0, which stands for every rank.
"""
from __future__ import annotations

import math

import torch

__all__ = ["is_dtensor", "split_last", "merge_last", "heads_local",
           "write_rows_local", "embed_rows", "xent_rows", "moe_dense",
           "ssd_local", "rglru_local", "roll_local", "layer_of",
           "set_layer", "reduced", "mean_last", "grad_placed",
           "place_like"]


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


def _dims_of(t, dim: int):
    """The mesh dims over which ``t`` shards tensor dim ``dim`` (none for
    a plain tensor)."""
    if not is_dtensor(t):
        return []
    return [i for i, p in enumerate(t.placements)
            if _sdim(p, t) == dim % t.dim()]


def _batch_dims(x):
    """The mesh dims that split ``x``'s leading (batch) dim: those of the
    active rules' ``batch`` axis on ``x``'s mesh (``dist.sharding``), or
    with no rules for it, those ``x`` is split over now. The rules, not
    ``x``'s placement: DTensor may have moved an activation's batch
    shards elsewhere, and a per-rank op would then run the whole batch
    on every rank."""
    from . import sharding as shr
    mesh = x.device_mesh
    if shr._ACTIVE and shr._ACTIVE[-1].mesh == mesh:
        entry = shr.spec_for(x.shape[:1], ("batch",), shr._ACTIVE[-1].rules,
                             mesh)[0]
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        return [list(mesh.mesh_dim_names).index(a) for a in axes]
    return _dims_of(x, 0)


def _spec(mesh, *parts):
    """Placements over ``mesh``: each (placement, mesh dims) of ``parts``
    on its dims, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate
    out = [Replicate()] * mesh.ndim
    for p, dims in parts:
        for i in dims:
            out[i] = p
    return out


def _per_rank(fn, args, ins, grads, outs, mesh):
    """``fn(*args)`` under ``local_map``: ``ins`` / ``grads`` the
    placements of the arguments and their gradients (None for a plain
    tensor), ``outs`` those of the results."""
    from torch.distributed.tensor.experimental import local_map
    ins = tuple(p if is_dtensor(a) else None for a, p in zip(args, ins))
    grads = tuple(p if is_dtensor(a) else None for a, p in zip(args, grads))
    return local_map(fn, out_placements=outs, in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


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


def grad_placed(t):
    """``t``; a DTensor's gradient is redistributed to ``t``'s placements,
    so that the gradients of a parameter's several uses (a tied
    embedding's lookup and unembedding) meet in one placement."""
    return _GradAs.apply(t) if is_dtensor(t) else t


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
    """``table[ids]`` (table (V, d)); on a DTensor table, each rank looks
    up its rows of the batch in its rows of the table, gathered over the
    ranks that split d: where the vocabulary is split, in its range of
    ids, the rows then summed over those ranks (one all-reduce); the
    backward is local."""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    table = grad_placed(table)
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


def _all_gather(t, groups):
    """``t`` of every rank of ``groups`` (mesh dims, outermost first)
    stacked in row-major rank order: (n, *t.shape)."""
    import torch.distributed._functional_collectives as funcol
    t = t[None]
    for g in reversed(groups):
        t = funcol.wait_tensor(funcol.all_gather_tensor(t, 0, g))
    return t


class _ScatterSum(torch.autograd.Function):
    """The sum of each rank's ``t`` over ``groups``, each rank keeping its
    block of dim 0 (a reduce-scatter over each group, outermost first:
    DTensor's ``Shard(0)`` over those mesh dims); the backward gathers
    the gradient's blocks."""

    @staticmethod
    def forward(ctx, t, groups):
        import torch.distributed._functional_collectives as funcol
        ctx.groups = groups
        for g in groups:
            t = funcol.wait_tensor(funcol.reduce_scatter_tensor(t, "sum", 0,
                                                                g))
        return t

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.groups).flatten(0, 1), None


class _SumOver(torch.autograd.Function):
    """The sum of each rank's ``t`` over ``groups``, replicated; the
    gradient (replicated) goes back to every rank's part unchanged."""

    @staticmethod
    def forward(ctx, t, groups):
        return _all_reduce(t, "sum", groups)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GradSum(torch.autograd.Function):
    """Identity; the gradient is summed over ``groups`` (the ranks that
    use the same input for different parts of the output)."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, "sum", ctx.groups), None


def moe_dense(x, router_w, w1, w3, w2, *, top_k: int,
              capacity_factor: float, dtype):
    """``layers.moe_ffn`` (x (B, S, d) -> (y, aux)). On a DTensor whose
    batch is split over token ranks, JAX's dispatch over all ``T = B *
    S`` tokens, per rank:

    * the rank routes its own tokens (``layers.moe_route``: top-k, the
      stable sort of its pairs by expert, the ``cummax`` ranks) and adds
      to each pair's rank the count of its expert's pairs on the token
      ranks before it (one all-gather of an (E,) count a rank: with the
      batch split in order, the rank in the stable sort of all T * k
      pairs), so ``keep`` and the drops under the global capacity ``C =
      ceil(T * k / E * cf)`` are JAX's pair for pair;
    * it writes its kept pairs into the (E, C, d) buffers, summed over
      the token ranks (every slot has one writer), each token rank
      keeping E / n experts' buffers where n divides E (a
      reduce-scatter; else an all-reduce, every rank with all E);
    * the experts run on DTensors (``layers.moe_experts``), so a rank
      runs only its experts' slots;
    * each rank combines its own pairs from the replicated outputs;
    * the load-balance loss from the router probabilities and picks
      summed over the token ranks.

    The collectives are the port's plan, not XLA's."""
    from ..models import layers as L
    kw = dict(top_k=top_k, capacity_factor=capacity_factor, dtype=dtype)
    if not is_dtensor(x):
        return L.moe_ffn(x, router_w, w1, w3, w2, **kw)
    from torch.distributed.tensor import Partial, Shard
    mesh = x.device_mesh
    B, S, d = x.shape
    E = router_w.shape[1]
    T = B * S
    C = L.moe_capacity(T, top_k, E, capacity_factor)
    tok = _batch_dims(x)
    groups = [mesh.get_group(i) for i in tok if mesh.size(i) > 1]
    first = _rank_along(mesh, tok)
    xp = _spec(mesh, (Shard(0), tok))       # x, and each rank's pairs
    rep = _spec(mesh)
    part = _spec(mesh, (Partial(), tok))
    n = math.prod(mesh.size(i) for i in tok)
    split = n > 1 and E % n == 0
    bp = xp if split else rep               # the capacity buffers

    def offsets(flat_e):
        cnt = torch.zeros(E, dtype=flat_e.dtype, device=flat_e.device)
        cnt.scatter_add_(0, flat_e, torch.ones_like(flat_e))
        return _all_gather(cnt, groups)[:first].sum(0)

    def route(xl, rw):
        xf = xl.reshape(-1, d)
        logits = L.mm(L.up32(xf), L.up32(rw))
        r = L.moe_route(logits, top_k, C, offsets if groups else None)
        buf = L.moe_dispatch(xf, r, E, C, dtype)
        pe = torch.softmax(logits, dim=-1).sum(dim=0)
        hits = torch.zeros(E, dtype=pe.dtype, device=xl.device)
        hits.scatter_add_(0, r["gidx"].reshape(-1), torch.ones(
            r["gidx"].numel(), dtype=pe.dtype, device=xl.device))
        if groups:
            buf = (_ScatterSum if split else _SumOver).apply(buf, groups)
            pe = _SumOver.apply(pe, groups)
            hits = _all_reduce(hits, "sum", groups)
        fe = hits / torch.clamp_min(hits.sum(), 1.0)
        aux = E * torch.sum(pe / T * fe)
        return buf, r["sg"], r["slot"], r["keep"], r["stt"], aux

    buf, *pairs, aux = _per_rank(
        route, (x, router_w), (xp, rep), (xp, part),
        (bp, xp, xp, xp, xp, rep), mesh)
    y = L.moe_experts(buf, w1, w3, w2, dtype)

    def combine(yl, sg, slot, keep, stt):
        r = dict(sg=sg, slot=slot, keep=keep, stt=stt)
        out = L.moe_combine(yl.reshape(E * C, d), r, sg.shape[0] // top_k,
                            dtype)
        return out.reshape(-1, S, d)

    out = _per_rank(combine, (y, *pairs), (rep, xp, xp, xp, xp),
                    (part, xp, xp, xp, xp), xp, mesh)
    return out, aux


def ssd_local(fn, x, dt, A, B_, C_, D, *state, **kw):
    """``fn(x, dt, A, B_, C_, D, *state, **kw)``, an SSD scan or step of
    ``models.ssm`` (x (B, S, H * P), dt (B, S, H), A / D (H,), B_ / C_
    (B, S, N), ``state`` the (B, H, P, N) recurrent state -> (y like x,
    the state)), per rank on DTensors: on its batch rows (x's batch
    shards) and its heads (A's shards), each head with its P channels
    of x (the heads split x's last dim as they split H). The chunks and
    the order of the sums are the plain program's. B_ and C_, shared by
    the heads, get their gradients summed over the head ranks (an
    all-reduce; DTensor would reduce-scatter a partial sum onto the
    sequence, a placement its backward matmuls cannot take)."""
    if not is_dtensor(x):
        return fn(x, dt, A, B_, C_, D, *state, **kw)
    from torch.distributed.tensor import Partial, Shard
    mesh = x.device_mesh
    bd = _batch_dims(x)
    hd = [i for i in _dims_of(A, 0) if i not in bd]
    xp = _spec(mesh, (Shard(0), bd), (Shard(2), hd))      # x, dt
    hp = _spec(mesh, (Shard(0), hd))                      # A, D
    hg = _spec(mesh, (Partial(), bd), (Shard(0), hd))
    np_ = _spec(mesh, (Shard(0), bd))                     # B_, C_
    sp = _spec(mesh, (Shard(0), bd), (Shard(1), hd))      # the state
    groups = [mesh.get_group(i) for i in hd if mesh.size(i) > 1]

    def local(x, dt, A, B_, C_, *rest):
        if groups:
            B_, C_ = _GradSum.apply(B_, groups), _GradSum.apply(C_, groups)
        return fn(x, dt, A, B_, C_, *rest, **kw)

    return _per_rank(local, (x, dt, A, B_, C_, D, *state),
                     (xp, xp, hp, np_, np_, hp) + (sp,) * len(state),
                     (xp, xp, hg, np_, np_, hg) + (sp,) * len(state),
                     (xp, sp), mesh)


def rglru_local(fn, x, r, i, lam, *state):
    """``fn(x, r, i, lam, *state)``, the RG-LRU scan or step of
    ``models.rglru`` (x / r / i (B, ..., D), lam (D,), ``state`` (B, D)
    -> (y like x, the (B, D) state)), per rank on DTensors: on its batch
    rows and its channels (lam's shards). The recurrence is elementwise
    over (B, D), so the ranks exchange nothing; ``r`` and ``i``, partial
    sums of a projection over the channel ranks, are reduce-scattered
    onto the channels."""
    if not is_dtensor(x):
        return fn(x, r, i, lam, *state)
    from torch.distributed.tensor import Partial, Shard
    mesh = x.device_mesh
    bd = _batch_dims(x)
    cd = [k for k in _dims_of(lam, 0) if k not in bd]
    xp = _spec(mesh, (Shard(0), bd), (Shard(x.dim() - 1), cd))
    lp = _spec(mesh, (Shard(0), cd))
    lg = _spec(mesh, (Partial(), bd), (Shard(0), cd))
    sp = _spec(mesh, (Shard(0), bd), (Shard(1), cd))
    return _per_rank(fn, (x, r, i, lam, *state),
                     (xp, xp, xp, lp) + (sp,) * len(state),
                     (xp, xp, xp, lg) + (sp,) * len(state), (xp, sp), mesh)


def roll_local(t, shift: int, dim: int):
    """``torch.roll(t, shift, dim)``; a DTensor rolls each rank's shard,
    ``dim`` whole on every rank."""
    if not is_dtensor(t):
        return torch.roll(t, shift, dims=dim)
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if _sdim(p, t) == dim % t.dim() else p
          for p in t.placements]
    return _per_rank(lambda a: torch.roll(a, shift, dims=dim), (t,),
                     (pl,), (pl,), pl, t.device_mesh)


def _layer_split(t, idx):
    """For ``t[idx]`` (``idx`` a tuple over t's leading dims): the mesh
    dims that split those dims (each group of a dim, outermost first),
    whether this rank holds the layer, and its index in the local
    block."""
    mesh = t.device_mesh
    dims, mine, local = [], True, []
    for d, i in enumerate(idx):
        md = _dims_of(t, d)
        n = t.shape[d] // math.prod(mesh.size(k) for k in md)
        mine = mine and _rank_along(mesh, md) == i // n
        dims += md
        local.append(i % n)
    return dims, mine, tuple(local)


def _rest(t, k: int, split):
    """``t``'s placements for ``t[idx]`` over its first ``k`` dims: the
    shards of later dims moved down by ``k``, ``Replicate()`` on the mesh
    dims in ``split`` (those of the indexed dims)."""
    from torch.distributed.tensor import Replicate, Shard
    return [Replicate() if i in split else
            Shard(_sdim(p, t) - k) if p.is_shard() else p
            for i, p in enumerate(t.placements)]


def layer_of(t, idx):
    """``t[idx]``, a view where ``t`` holds the layer whole; on a DTensor
    whose indexed dims are split, each rank's copy of the layer: the
    holder's block summed with zeros from the others (an all-reduce)."""
    idx = idx if isinstance(idx, tuple) else (idx,)
    if not is_dtensor(t) or not any(_dims_of(t, d)
                                    for d in range(len(idx))):
        return t[idx]
    from torch.distributed.tensor import DTensor
    mesh = t.device_mesh
    split, mine, li = _layer_split(t, idx)
    blk = t.to_local()[li]
    if not mine:
        blk = torch.zeros_like(blk)
    blk = _all_reduce(blk, "sum", [mesh.get_group(i) for i in split])
    shape = t.shape[len(idx):]
    return DTensor.from_local(blk, mesh, _rest(t, len(idx), split),
                              run_check=False, shape=shape,
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def set_layer(t, idx, new):
    """``t[idx].copy_(new)``; on a DTensor whose indexed dims are split,
    ``new`` is placed as the layer's block and its holder writes it."""
    idx = idx if isinstance(idx, tuple) else (idx,)
    if not is_dtensor(t) or not any(_dims_of(t, d)
                                    for d in range(len(idx))):
        t[idx].copy_(new)
        return
    split, mine, li = _layer_split(t, idx)
    new = new.redistribute(t.device_mesh, _rest(t, len(idx), split))
    if mine:
        t.to_local()[li].copy_(new.to_local())


def reduced(x):
    """``x``; a DTensor that is a partial sum over some mesh dims is
    summed over them first (an all-reduce, Partial -> Replicate)."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def mean_last(x):
    """``x.mean(-1, keepdim=True)``; on a DTensor, the sum over the last
    dim reduced over the ranks that split it (``reduced``), then divided
    by its length (a reduced mean would leave a partial average, which
    the backward cannot meet with a partial sum)."""
    if not is_dtensor(x):
        return torch.mean(x, dim=-1, keepdim=True)
    return reduced(torch.sum(x, dim=-1, keepdim=True)) / x.shape[-1]


def place_like(t, ref):
    """``t`` placed as ``ref`` where both are DTensors; else ``t``."""
    if is_dtensor(t) and is_dtensor(ref) and \
            tuple(t.placements) != tuple(ref.placements):
        return t.redistribute(ref.device_mesh, ref.placements)
    return t
