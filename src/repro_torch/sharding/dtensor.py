"""What the models do on a DTensor mesh: the dry run's sharded count
(``launch.dryrun``: DTensors over a fake process group, shapes only).

The mesh reaches the models as ``Runtime.dmesh`` and as DTensor
parameters, batch and caches.  Every function here takes a plain tensor
as it is, with the operations the models ran before there was a DTensor
path (the eager and kernel paths keep their bits), and a DTensor the way
XLA's partitioner takes the reference's program:

- the batch constraint (:func:`shard_batch`, the reference's
  ``with_sharding_constraint``), a period's FSDP gather
  (:func:`fsdp_gathered`) and the all-reduce that closes a
  tensor-parallel sublayer (:func:`summed`);
- regions run chip by chip (:func:`on_chips`, :func:`attention_on_chips`,
  :func:`slstm_region`), the counterpart of the reference's ``shard_map``
  and of what XLA does with a computation local along batch, channels,
  heads and experts: DTensor's operation-by-operation propagation both
  slows a loop (each step pays it) and, on views of sharded dims, fails
  to find a strategy;
- heads kept whole (:func:`split_heads`, :func:`merge_heads`), a norm's
  features gathered (:func:`whole_features`), padding without ``F.pad``
  (:func:`pad`), the vocab-sharded loss and greedy token;
- the training step's gradient placement (:func:`gradient_placed`), its
  microbatches (:func:`microbatches`) and the optimizer's shardwise
  update (:func:`shardwise`).

Count-only sites.  A few sites give each chip a block with the shapes and
the work of XLA's partitioned program but not its values: :func:`halves`
(each chip halves its own block of a fused projection, where XLA permutes
the halves between the chips), the kv heads of a chip's query groups
(:func:`attention_on_chips`), a chip's share of the experts and of a
spread group's tokens (:func:`chips_share`), a sequence-sharded cache's
slot (:func:`write_slot`) and chip-major microbatches
(:func:`microbatches`).  These run on fake tensors only and raise
``NotImplementedError`` on a DTensor that holds values.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

try:
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
except ImportError:          # a build of torch without torch.distributed
    DTensor = None


def is_dtensor(t) -> bool:
    return DTensor is not None and isinstance(t, DTensor)


def _count_only(what: str, *tensors) -> None:
    """Raises unless every tensor is fake (``FakeTensorMode``, the dry
    run's): ``what`` gives a chip the shapes and work of its block, not
    its values (module docstring)."""
    from torch._subclasses.fake_tensor import is_fake
    if not all(is_fake(t) for t in tensors):
        raise NotImplementedError(
            f"{what} is the dry run's count: it takes fake tensors only")


def _ways(t, dim: int) -> int:
    """How many ways the DTensor ``t`` splits ``dim`` (1 for a plain
    tensor)."""
    if not is_dtensor(t):
        return 1
    ways = 1
    for p, n in zip(t.placements, t.device_mesh.shape):
        ways *= n if p.is_shard(dim % t.dim()) else 1
    return ways


def _local(t, placements, grads=None):
    """The DTensor ``t`` at ``placements``, its local block, whose
    gradient arrives at ``grads`` (default ``placements``)."""
    return t.redistribute(t.device_mesh, placements).to_local(
        grad_placements=grads or placements)


# -- constraints --------------------------------------------------------------


def constrained(x, placements):
    """The DTensor ``x`` at ``placements``, and its gradient at them too,
    as ``with_sharding_constraint`` constrains a cotangent as well: a
    gradient that arrives as partial sums is reduced here, one sharded
    otherwise is moved here."""
    return DTensor.from_local(_local(x, placements), x.device_mesh,
                              placements, run_check=False)


def shard_batch(x, runtime):
    """Dim 0 (batch) of an activation placed on ``runtime``'s batch axes,
    replicated over the others: the reference's
    ``with_sharding_constraint``, which keeps XLA's propagation from
    replicating the batch.  Only on a DTensor mesh and where the batch
    divides the axes; otherwise ``x`` as it is (a tensor's device is its
    placement)."""
    from repro_torch.sharding.rules import P, dtensor_placements
    dmesh = runtime.dmesh
    if (dmesh is None or not runtime.batch_axes or x.dim() < 2
            or x.shape[0] % max(runtime.batch_axis_size, 1)):
        return x
    return constrained(x, dtensor_placements(P(tuple(runtime.batch_axes)),
                                             dmesh))


_EXPERT_LEAVES = {"we_gate", "we_up", "we_down"}


def fsdp_gathered(leaves, runtime):
    """A period's weights (or the training loss's unembedding) gathered
    over the batch axes, kept on their other shards: the all-gather of a
    layer's FSDP shards where the layer runs, as XLA places it, whose
    backward reduce-scatters the gradient.  The experts stay as the
    sharding rules place them (the MoE region takes them).  Without a
    DTensor mesh, ``leaves`` as they are."""
    from repro_torch.sharding.rules import map_with_path
    dmesh = runtime.dmesh
    if dmesh is None or not runtime.batch_axes:
        return leaves
    dims = {dmesh.mesh_dim_names.index(a) for a in runtime.batch_axes}

    def gather(path, a):
        if not is_dtensor(a) or path[-1] in _EXPERT_LEAVES:
            return a
        whole = [Replicate() if i in dims else p
                 for i, p in enumerate(a.placements)]
        return a if whole == list(a.placements) else a.redistribute(
            dmesh, whole)
    return map_with_path(gather, leaves)


def summed(y):
    """A sublayer's output with its pending partial sums (a row-parallel
    product's) reduced: the all-reduce that closes a tensor-parallel
    sublayer.  Any other tensor as it is."""
    if not is_dtensor(y) or not any(p.is_partial() for p in y.placements):
        return y
    return constrained(y, [Replicate() if p.is_partial() else p
                           for p in y.placements])


def whole_features(x):
    """A DTensor whose last dim is sharded gathered on it, its gradient
    placed alike: a norm reduces over the features, where DTensor would
    move the sharding onto the sequence instead.  Any other ``x`` as it
    is."""
    if _ways(x, -1) == 1:
        return x
    last = x.dim() - 1
    return constrained(x, [Replicate() if p.is_shard(last) else p
                           for p in x.placements])


def summed_onto_features(t):
    """A DTensor's pending partial sums (a row-parallel product's)
    reduced onto its last dim's shards (a reduce-scatter; replicated
    where the dim does not split), its gradient placed alike: DTensor
    would otherwise scatter them onto the sequence.  Any other ``t`` as
    it is."""
    if not is_dtensor(t) or not any(p.is_partial() for p in t.placements):
        return t
    ways = 1
    target = []
    for p, n in zip(t.placements, t.device_mesh.shape):
        if p.is_partial() and t.shape[-1] % (ways * n) == 0:
            ways *= n
            target.append(Shard(t.dim() - 1))
        else:
            target.append(Replicate() if p.is_partial() else p)
    return constrained(t, target)


# -- shapes -------------------------------------------------------------------


def halves(t: torch.Tensor):
    """``t.chunk(2, dim=-1)``: the two halves of a fused projection's
    output.  On a DTensor whose last dim is sharded each chip halves its
    own block, as two projections sharded alike would give it: the
    halves' shapes and work, not their values (count only; XLA permutes
    one half between the chips, and its gradient's concatenation is an
    all-to-all, which this counts as nothing)."""
    ways = _ways(t, -1)
    if ways == 1 or (t.shape[-1] // 2) % ways:
        return t.chunk(2, dim=-1)
    _count_only("halving each chip's block of a fused projection", t)
    shape = (*t.shape[:-1], t.shape[-1] // 2)
    stride = torch.empty(shape, device="meta").stride()
    return tuple(DTensor.from_local(h, t.device_mesh, t.placements,
                                    run_check=False, shape=shape,
                                    stride=stride)
                 for h in t.to_local().chunk(2, dim=-1))


def placed_like(t: torch.Tensor, ref, dim: int) -> torch.Tensor:
    """A plain tensor ``t`` to be joined with the DTensor ``ref`` along
    ``dim`` (a zero state before a sequence), cut to ``ref``'s shards on
    its other dims (a local cut, no collective).  Any other ``t`` as it
    is."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False).redistribute(mesh, [
        Replicate() if p.is_shard(dim) or p.is_partial() else p
        for p in ref.placements])


def pad(t: torch.Tensor, dim: int, before: int, after: int):
    """``t`` with ``before`` and ``after`` zeros along ``dim``
    (``F.pad``); a DTensor is joined to zeros placed like it, as some
    DTensor versions cannot pad one."""
    dim %= t.dim()
    if not is_dtensor(t):
        return F.pad(t, [0, 0] * (t.dim() - 1 - dim) + [before, after])
    parts = []
    for n in (before, after):
        shape = list(t.shape)
        shape[dim] = n
        parts.append(placed_like(torch.zeros(shape, dtype=t.dtype), t, dim)
                     if n else None)
    return torch.cat([p for p in (parts[0], t, parts[1]) if p is not None],
                     dim=dim)


def merge_heads(t: torch.Tensor, *shape) -> torch.Tensor:
    """``t.reshape(*shape)``, its (heads, head dim) merged into one dim.
    On a DTensor the gradient is placed as the forward's result before
    it is split into heads again (DTensor cannot split a dim sharded more
    ways than the heads)."""
    out = t.reshape(*shape)
    return constrained(out, out.placements) if is_dtensor(out) else out


def split_heads(t: torch.Tensor, *shape) -> torch.Tensor:
    """``t.reshape(*shape)``, its last dim split into (heads, head dim).
    A DTensor whose last dim is sharded more ways than the heads split is
    gathered on those mesh dims first: a head is never split across
    chips, as the sharding rules keep it."""
    if shape[-2] % _ways(t, -1):
        last = t.dim() - 1
        t = t.redistribute(t.device_mesh, [
            Replicate() if p.is_shard(last) else p for p in t.placements])
    return t.reshape(*shape)


# -- regions ------------------------------------------------------------------


def _axes(inputs, dims, dmesh) -> list:
    """The logical axis each mesh dim splits (None: gathered): an axis an
    input is sharded along on that mesh dim, the largest input's first,
    where every input that has the axis splits evenly that many more
    ways."""
    out = [None] * dmesh.ndim
    ways: dict = {}

    def even(axis, n) -> bool:
        return all(x.shape[d[axis]] % (ways.get(axis, 1) * n) == 0
                   for x, d in zip(inputs, dims)
                   if d and axis in d and hasattr(x, "shape"))

    # the largest inputs first: their layout is the one kept
    pairs = sorted(((x, d) for x, d in zip(inputs, dims)
                    if d and is_dtensor(x)), key=lambda xd: -xd[0].numel())
    for x, d in pairs:
        for i, p in enumerate(x.placements):
            if out[i] is not None or not p.is_shard():
                continue
            names = [a for a, dim in d.items() if dim == p.dim % x.dim()]
            if names and even(names[0], dmesh.size(i)):
                out[i] = names[0]
                ways[names[0]] = ways.get(names[0], 1) * dmesh.size(i)
    return out


def on_chips(fn, inputs, dims, out_dims):
    """``fn(*inputs)`` chip by chip.  ``dims`` gives each input's
    ``{axis: dim}`` (None for a non-tensor), ``out_dims`` each output's
    ``{axis: dim or "sum" or "avg"}``.  A mesh dim along which some input
    is sharded on a named dim splits that axis; every input that has the
    axis takes its block along it (a local cut where it was replicated),
    and one that lacks it goes in whole, its gradient then a partial sum
    over that mesh dim.  Any other mesh dim is gathered and computed on
    every chip alike.  An axis an output lacks is replicated or, named
    ``"sum"`` or ``"avg"``, a pending reduction.  Without a DTensor among
    the inputs, ``fn(*inputs)``."""
    mesh_of = next((x for x in inputs if is_dtensor(x)), None)
    if mesh_of is None:
        return fn(*inputs)
    dmesh = mesh_of.device_mesh
    axes = _axes(inputs, dims, dmesh)
    whole = [Replicate()] * dmesh.ndim
    local = []
    for x, d in zip(inputs, dims):
        if d is None:
            local.append(x)
            continue
        if not is_dtensor(x):
            x = DTensor.from_local(x, dmesh, whole, run_check=False)
        local.append(_local(
            x, [Shard(d[a]) if a in d else Replicate() for a in axes],
            [Shard(d[a]) if a in d else
             Partial() if a is not None else Replicate() for a in axes]))
    outs = fn(*local)
    single = not isinstance(outs, tuple)
    wrapped = []
    for y, d in zip((outs,) if single else outs, out_dims):
        if y is None or d is None:
            wrapped.append(y)
            continue
        placements = []
        for a in axes:
            v = d.get(a) if a is not None else None
            placements.append(Shard(v) if isinstance(v, int) else
                              Partial(v) if v else Replicate())
        wrapped.append(DTensor.from_local(y, dmesh, placements,
                                          run_check=False))
    return wrapped[0] if single else tuple(wrapped)


def attention_on_chips(fn, q, k, v, *rest):
    """``fn(q, k, v, *rest)`` for q (B,Sq,H,hd) and k, v (B,Sk,K,hd); on
    DTensors run on each chip's block, as XLA partitions attention over
    batch and heads: the batch stays on its shards (q's or the keys', the
    larger's layout kept), the heads on the keys' shards with q's alike,
    or, where the kv heads do not split, as many kv heads as the chip's
    query groups use cut from their replicas (count only: the first
    ones, not the chip's own; their gradient then a partial sum); any
    other placement is gathered first.  ``rest`` is replicated."""
    if not is_dtensor(q):
        return fn(q, k, v, *rest)
    dmesh = q.device_mesh
    B, H, K = q.shape[0], q.shape[2], k.shape[2]
    qp, kp, kgrad = [], [], []
    rows = 1                       # the ways the rows split
    for pq, pk, n in zip(q.placements, k.placements, dmesh.shape):
        if (pq.is_shard(0) or pk.is_shard(0)) and B % (rows * n) == 0:
            rows *= n
            qp.append(Shard(0))
            kp.append(Shard(0))
            kgrad.append(Shard(0))
        elif pk.is_shard(2) and K % n == 0:
            qp.append(Shard(2))
            kp.append(Shard(2))
            kgrad.append(Shard(2))
        elif pq.is_shard(2) and not pk.is_shard():
            qp.append(Shard(2))
            kp.append(Replicate())
            kgrad.append(Partial())
        else:
            qp.append(Replicate())
            kp.append(Replicate())
            kgrad.append(Replicate())
    heads = kv_ways = 1
    for pq, pk, size in zip(qp, kp, dmesh.shape):
        heads *= size if pq.is_shard(2) else 1
        kv_ways *= size if pk.is_shard(2) else 1
    h_loc, G = H // heads, H // K
    k_loc = K // kv_ways
    if kv_ways != heads:           # cut the kv heads the chip's groups use
        if h_loc % G and G % h_loc:
            return attention_on_chips(fn, q.redistribute(dmesh, [
                Replicate() if p.is_shard(2) else p for p in q.placements]),
                k, v, *rest)
        _count_only("the kv heads of a chip's query groups", q, k, v)
        k_loc = max(h_loc // G, 1)
    whole = [Replicate()] * dmesh.ndim
    kl, vl = (_local(t, kp, kgrad)[:, :, :k_loc] for t in (k, v))
    rest = [_local(r, whole) if is_dtensor(r) else r for r in rest]
    return DTensor.from_local(fn(_local(q, qp), kl, vl, *rest), dmesh, qp,
                              run_check=False)


def slstm_region(recurrence, params, xconv, state, runtime):
    """``recurrence(used, xconv, state)`` (the sLSTM's) on each chip's
    rows, the counterpart of the reference's ``shard_map`` region: the
    gate weights replicated into it (an all-gather where they are FSDP
    shards), the inputs and states on the batch axes, and the loop on
    local tensors.  The weights leave as local tensors whose gradient is
    a partial sum over the batch axes, so their gradient is reduced once,
    after the loop, as the region's psum is."""
    from repro_torch.sharding.rules import P, dtensor_placements
    dmesh = runtime.dmesh
    rows = dtensor_placements(P(tuple(runtime.batch_axes)), dmesh)
    whole = [Replicate()] * dmesh.ndim
    partial = [Partial() if p != Replicate() else p for p in rows]

    def local(t):
        if not is_dtensor(t):
            t = DTensor.from_local(t, dmesh, whole, run_check=False)
        return _local(t, rows)

    used = {k: _local(params[k], whole, partial)
            for k in ("w_gates", "r_gates", "b_gates")}
    hs, core = recurrence(used, local(xconv),
                          {k: local(state[k]) for k in "cnhm"})

    def rows_of(t):
        return DTensor.from_local(t, dmesh, rows, run_check=False)
    return rows_of(hs), {k: rows_of(v) for k, v in core.items()}


# -- the experts --------------------------------------------------------------


def expert_layout(x, n_groups: int):
    """How the chips split the MoE's token groups, as ``on_chips`` dims:
    (the tokens' dims, the router means' dims, ``spread``).  Each chip
    its own whole groups; or one group's tokens over all of them, its
    routing gathered and its experts' inputs summed (XLA's plan; then
    ``spread`` is (gather, reduce), :func:`_spread_over`); or, else,
    every group on every chip, the tokens gathered.  A plain ``x``: each
    its own groups, no spread."""
    rows, means = {"batch": 0}, {"batch": "avg"}
    ways = _ways(x, 0)
    if ways > 1 and n_groups % ways:
        if n_groups == 1:
            return rows, {}, _spread_over(x)
        return {}, {}, None
    return rows, means, None


def _spread_over(x):
    """(gather, reduce) for one group whose tokens lie on the chips of
    ``x``'s batch shards: ``gather(t)`` joins a local (1, n, ...) block
    along dim 1 (an all-gather), ``reduce(t)`` sums a local partial (an
    all-reduce), both over the batch's mesh dims."""
    mesh = x.device_mesh
    batch = [p.is_shard(0) for p in x.placements]
    whole = [Replicate()] * mesh.ndim

    def joined(t, placements):
        return DTensor.from_local(t, mesh, placements, run_check=False) \
            .redistribute(mesh, whole).to_local()

    return (lambda t: joined(t, [Shard(1) if b else Replicate()
                                 for b in batch]),
            lambda t: joined(t, [Partial() if b else Replicate()
                                 for b in batch]))


def chips_share(dispatch, gates, experts: int, tokens=None):
    """A chip's share of a group's routing ``dispatch`` (G, S_g, E, C)
    and ``gates``: as many experts as the chip holds and, with
    ``tokens``, as many of a spread group's tokens as it holds.  The
    first ones, not the chip's own: the shapes and work, not the values
    (count only)."""
    _count_only("a chip's share of the experts", dispatch, gates)
    held, g = dispatch, gates
    if experts < dispatch.shape[2]:
        held, g = held[:, :, :experts], g[:, :, :experts]
    if tokens is not None:
        held, g = held[:, :tokens], g[:, :tokens]
    return held, g


# -- decode's caches ----------------------------------------------------------


def seq_sharded(t) -> bool:
    """Whether ``t`` is a DTensor sharded on dim 1 (a cache's
    sequence)."""
    return is_dtensor(t) and any(p.is_shard(1) for p in t.placements)


def write_slot(cache, pos: int, new) -> None:
    """``cache[:, pos] = new`` in place (cast to the cache's type).  On a
    DTensor cache whose sequence is sharded, each chip writes slot ``pos``
    modulo its block, ``new`` cut to the cache's other shards: one slot's
    write on every chip, as XLA's dynamic-update-slice on a sharded dim
    (count only: a plain index would gather the whole cache)."""
    if not seq_sharded(cache):
        cache[:, pos] = new.to(cache.dtype)
        return
    _count_only("a write into a sequence-sharded cache", cache, new)
    placements = [Replicate() if p.is_shard(1) else
                  Shard(p.dim - 1) if p.is_shard() and p.dim > 1 else p
                  for p in cache.placements]
    local = cache.to_local()
    local[:, pos % local.shape[1]] = new.redistribute(
        cache.device_mesh, placements).to_local().to(cache.dtype)


def gathered_where_keys_split(q, keys):
    """``q`` replicated over the mesh dims that split the keys'
    sequence, where its heads cannot stay split.  A plain ``q`` as it
    is."""
    if not is_dtensor(q):
        return q
    return q.redistribute(q.device_mesh, [
        Replicate() if pk.is_shard(1) else pq
        for pq, pk in zip(q.placements, keys.placements)])


# -- the vocabulary -----------------------------------------------------------


def vocab_sharded(logits) -> bool:
    """Whether ``logits`` is a DTensor whose last (vocab) dim is
    sharded."""
    return _ways(logits, -1) > 1


def _vocab_blocks(logits):
    """A vocab-sharded DTensor's local block, the first vocab index it
    holds, ``reduce(t, op)`` (a local (..,) tensor reduced over the vocab's
    mesh dims: one all-reduce) and the placements of a result over the
    rows (the logits' other placements)."""
    logits = summed(logits)
    dmesh = logits.device_mesh
    last = logits.dim() - 1
    vocab = [p.is_shard(last) for p in logits.placements]
    rows = [Replicate() if v else p
            for v, p in zip(vocab, logits.placements)]
    local = logits.to_local()
    start = 0
    for dim, v in enumerate(vocab):
        if v:
            start = start * dmesh.size(dim) + dmesh.get_local_rank(dim)

    def reduce(t, op="sum"):
        return DTensor.from_local(
            t, dmesh, [Partial(op) if v else p for v, p in zip(vocab, rows)],
            run_check=False).redistribute(dmesh, rows).to_local()
    return local, start * local.shape[-1], reduce, rows


def blockwise_ce(local, start: int, labels, reduce):
    """The logsumexp and the label's logit of logits whose vocab block
    ``local`` (..., V_block) starts at ``start``, as a partitioner takes
    them: each chip reduces its block (the max, the sum of the
    exponentials, the label's logit where the block holds it), then
    ``reduce`` (one all-reduce each; the identity for one block)."""
    width = local.shape[-1]
    m = reduce(local.detach().amax(dim=-1), "max")
    logz = torch.log(reduce(torch.exp(local - m[..., None]).sum(-1))) + m
    lab = labels.long() - start
    hit = (lab >= 0) & (lab < width)
    ll = reduce(torch.gather(local, -1, lab.clamp(0, width - 1)[..., None])
                [..., 0] * hit)
    return logz, ll


def vocab_sharded_ce(logits, labels):
    """:func:`blockwise_ce` of vocab-sharded logits (B,C,V): (logz, the
    label's logit), DTensors over the rows."""
    local, start, reduce, rows = _vocab_blocks(logits)
    mesh = logits.device_mesh
    logz, ll = blockwise_ce(local, start,
                            labels.redistribute(mesh, rows).to_local(),
                            reduce)
    return tuple(DTensor.from_local(t, mesh, rows, run_check=False)
                 for t in (logz, ll))


def blockwise_argmax(local, start: int, reduce):
    """The first index of the largest value over the vocab of logits whose
    block ``local`` starts at ``start``, as ``argmax``: each chip takes
    its block's max and first index, then an all-reduce of the maxima
    and one of the smallest index that holds the global one."""
    best, idx = local.max(dim=-1)
    top = reduce(best, "max")
    far = torch.iinfo(idx.dtype).max
    idx = torch.where(best == top, idx + start, torch.full_like(idx, far))
    return reduce(idx, "min")


def greedy_token(logits) -> torch.Tensor:
    """The argmax over the vocab of ``logits`` (..., V), int32; on
    vocab-sharded logits :func:`blockwise_argmax`."""
    if not vocab_sharded(logits):
        return logits.argmax(dim=-1).to(torch.int32)
    local, start, reduce, rows = _vocab_blocks(logits)
    return DTensor.from_local(
        blockwise_argmax(local, start, reduce).to(torch.int32),
        logits.device_mesh, rows, run_check=False)


# -- the training step --------------------------------------------------------


def gradient_placed(grad, param):
    """A DTensor gradient placed as its parameter, the reference's
    ``out_shardings``: a partial sum over the batch axes is reduced here
    (an all-reduce, or a reduce-scatter onto an FSDP shard), one
    all-reduce over all the mesh dims it spans, as XLA's, where DTensor
    would run one a dim.  Any other gradient as it is."""
    if not is_dtensor(grad):
        return grad
    mesh = grad.device_mesh
    dims = [i for i, (g, p) in enumerate(zip(grad.placements,
                                              param.placements))
            if g.is_partial() and p == Replicate()]
    if len(dims) > 1:
        flat = mesh[tuple(mesh.mesh_dim_names[i] for i in dims)]._flatten()
        local = DTensor.from_local(grad.to_local(), flat, [Partial()],
                                   run_check=False).redistribute(
                                       flat, [Replicate()]).to_local()
        grad = DTensor.from_local(local, mesh, [
            Replicate() if i in dims else g
            for i, g in enumerate(grad.placements)], run_check=False)
    return grad.redistribute(mesh, param.placements)


def microbatches(leaf, axis: int, n: int):
    """``leaf.chunk(n, dim=axis)``; a DTensor sharded on ``axis`` is cut
    chip by chip: microbatch ``i`` holds each chip's ``i``-th slice of its
    rows, so each chip's block has the shape the reference's
    ``reshape(n, B / n, ...)`` gives it and no rows move (chunking the
    global axis would all-gather it).  Those are not the reference's rows
    (count only)."""
    if not (is_dtensor(leaf)
            and any(p.is_shard(axis) for p in leaf.placements)):
        return leaf.chunk(n, dim=axis)
    _count_only("chip-major microbatches", leaf)
    local = leaf.to_local()
    if local.shape[axis] % n:
        raise ValueError(f"a chip's {local.shape[axis]} rows do not "
                         f"split into {n} microbatches")
    return [DTensor.from_local(piece, leaf.device_mesh, leaf.placements,
                               run_check=False)
            for piece in local.chunk(n, dim=axis)]


def shardwise(fn, g, m, v, p):
    """``fn(g, m, v, p)`` of an elementwise update on each chip's shards
    of DTensor leaves placed alike: flattening a sharded DTensor would
    all-gather it.  Returns a DTensor placed as ``p``."""
    if not all(t.placements == p.placements for t in (g, m, v)):
        raise ValueError("AdamW takes DTensor leaves placed alike")
    out = fn(g.to_local(), m.to_local(), v.to_local(), p.to_local())
    return DTensor.from_local(out, p.device_mesh, p.placements,
                              run_check=False, shape=p.shape,
                              stride=p.stride())
