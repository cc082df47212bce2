"""Path-based partition specs: parameters, optimizer state, batches, caches
(port of ``repro.sharding.rules``).

Strategy, as in the reference:
  - tensor parallel over ``model``: column-parallel projections shard their
    output feature dim, row-parallel their input dim; attention projections
    shard only when the head count divides the axis (a head is never
    split); MoE experts shard the expert dim (expert parallelism); the
    vocabulary shards the embedding and unembedding;
  - FSDP over ``data`` (and ``pod``): large leaves additionally shard a
    non-TP dim when it divides (threshold ``fsdp_min_bytes``);
  - anything that does not divide stays replicated, so the rules never give
    an invalid layout for any (arch x mesh).

A spec is a :class:`P`, a tuple with one entry per dim: an axis name, a
tuple of axis names, or None (replicated).  :class:`NamedSharding` pairs a
spec with a :class:`~repro_torch.launch.mesh.Mesh` and gives the shard a
device holds.  Paths are tuples of the port's tree keys (dict keys as
strings, list indices as ints), walked in the trees' order (dict keys
sorted); the leaf names are the contract with ``repro_torch.models``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig


class P(tuple):
    """Partition spec: ``P("data", None)`` shards dim 0 over ``data``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: each dim's entry names the mesh axes it splits
    over, the remaining axes hold copies."""

    mesh: object
    spec: P

    def shard_shape(self, global_shape) -> tuple:
        """The shape of the block one device holds."""
        out = []
        for i, n in enumerate(global_shape):
            entry = self.spec[i] if i < len(self.spec) else None
            ways = int(np.prod([self.mesh.shape[a] for a in _axes(entry)]))
            if n % ways:
                raise ValueError(f"dim {i} of {tuple(global_shape)} does "
                                 f"not split {ways} ways ({self.spec})")
            out.append(n // ways)
        return tuple(out)

    def shard_bytes(self, leaf) -> int:
        """Bytes of ``leaf``'s block on one device."""
        return (int(np.prod(self.shard_shape(_shape(leaf))))
                * leaf.element_size())


def dtensor_placements(spec: P, dmesh) -> list:
    """``spec`` as DTensor placements on ``dmesh`` (a ``DeviceMesh`` with
    the port mesh's axis names, ``launch.mesh.dtensor_mesh``): a dim whose
    entry names axes is ``Shard(dim)`` on each of those mesh dims, every
    other mesh dim ``Replicate()``.  An entry of several axes splits
    major to minor, as JAX's; that is plain ``Shard``'s order only where
    the entry names them in the mesh's order, so any other order
    raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(dmesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        dims = [names.index(a) for a in _axes(entry)]
        if dims != sorted(dims):
            raise ValueError(f"{spec}: axes {_axes(entry)} are not in the "
                             f"mesh's order {names}")
        for d in dims:
            out[d] = Shard(dim)
    return out


def _shape(leaf) -> tuple:
    return tuple(leaf.shape)


def _nbytes(leaf) -> int:
    return leaf.numel() * leaf.element_size()


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and sequences, keys sorted."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], path + (k,))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def leaves_with_path(tree, path=()) -> list:
    """``[(path, leaf)]`` in :func:`map_with_path` order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in leaves_with_path(v, path + (i,))]
    return [(path, tree)]


@dataclass(frozen=True)
class MeshPlan:
    """Axis layout of the production mesh."""

    batch_axes: Tuple[str, ...] = ("data",)    # ("pod","data") multi-pod
    tp_axis: str = "model"
    fsdp_axis = "data"                         # may be a tuple of axes
    fsdp_min_bytes: int = 1 << 22              # 4 MiB
    enable_fsdp: bool = True
    enable_tp: bool = True                     # False: pure data parallelism
    attn_tp: bool = True                       # False: replicate q/o (decode
                                               # with non-shardable kv heads)
    # serving: shard experts over data x model (2-D EP+TP) so no weight is
    # re-gathered per decoded token
    expert_data_shard: bool = False
    # serving: additionally shard the embedding/unembed tables over the
    # data axes
    dense_2d_shard: bool = False

    def axis_size(self, mesh, name) -> int:
        if isinstance(name, tuple):
            return int(np.prod([mesh.shape[a] for a in name]))
        return mesh.shape[name]


def small_model_plan(batch_axes: Tuple[str, ...], tp_axis: str,
                     param_count: int) -> MeshPlan:
    """Plan for small archs: TP off, batch over every axis, FSDP over the
    combined axis for the members above 0.75 B parameters (the
    reference's reasons: per-layer and per-timestep TP collectives cost
    far more than a small model's compute)."""
    plan = MeshPlan(batch_axes=tuple(batch_axes) + (tp_axis,),
                    enable_tp=False,
                    enable_fsdp=param_count > 750_000_000)
    object.__setattr__(plan, "_fsdp_axes", tuple(batch_axes) + (tp_axis,))
    return plan


# column-parallel (shard output dim -1), row-parallel (shard input dim -2)
_COL = {"wq", "wk", "wv", "wi", "wg", "up_proj", "in_proj",
        "wq_a", "wq_b", "wkv_b", "unembed"}
_ROW = {"wo", "wdown", "down_proj", "out_proj", "dt_proj", "x_proj", "xwo"}
_CROSS_COL = {"xwq", "xwk", "xwv"}
_EXPERT = {"we_gate", "we_up", "we_down"}
# sLSTM gate weights are replicated: TP-sharding a per-timestep recurrence
# puts a collective in every timestep.  w_if (mLSTM gates) is tiny; same
# treatment.
_REPLICATE = {"scale", "bias", "bq", "bk", "bv", "b_if", "b_gates", "conv_w",
              "conv_b", "dt_bias", "A_log", "D", "router", "wkv_a", "b",
              "w_gates", "r_gates", "w_if"}

# attention-projection leaves gated on head divisibility
_Q_HEAD_LEAVES = {"wq", "xwq", "wq_b"}
_KV_HEAD_LEAVES = {"wk", "wv", "xwk", "xwv"}
_O_HEAD_LEAVES = {"wo", "xwo"}


def _head_aligned(cfg: ArchConfig, name: str, tp: int) -> bool:
    if cfg.mla is not None:
        # MLA: wq_b/wkv_b/wo all carry n_heads; kv latents are replicated
        return cfg.n_heads % tp == 0
    if name in _Q_HEAD_LEAVES or name in _O_HEAD_LEAVES:
        return cfg.n_heads % tp == 0
    if name in _KV_HEAD_LEAVES:
        return cfg.n_kv_heads % tp == 0
    return True


def _leaf_name(path) -> str:
    """The last dict key on ``path`` (the reference's last ``DictKey``)."""
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def _in_module(path, module: str) -> bool:
    return any(isinstance(e, str) and e == module for e in path)


def param_pspec(path, leaf, cfg: ArchConfig, mesh, plan: MeshPlan) -> P:
    name = _leaf_name(path)
    shape = _shape(leaf)
    nd = len(shape)
    tp = plan.axis_size(mesh, plan.tp_axis) if plan.enable_tp else 1
    fsdp_axis = getattr(plan, "_fsdp_axes", None) or plan.fsdp_axis
    fsdp = plan.axis_size(mesh, fsdp_axis)
    spec = [None] * nd

    def try_assign(dim: int, axis, size: int) -> bool:
        d = dim % nd
        if spec[d] is None and shape[d] % size == 0 and size > 1:
            spec[d] = axis
            return True
        return False

    is_attn_leaf = (name in _Q_HEAD_LEAVES | _KV_HEAD_LEAVES | _O_HEAD_LEAVES
                    or name in {"wkv_b"})
    head_ok = _head_aligned(cfg, name, tp) and plan.attn_tp

    if name == "embedding":
        try_assign(-2, plan.tp_axis, tp)               # vocab over model
        if plan.dense_2d_shard:                        # serving: 2-D table
            baxes = tuple(plan.batch_axes)
            try_assign(-1, baxes if len(baxes) > 1 else baxes[0],
                       plan.axis_size(mesh, baxes))
        return P(*spec)            # never FSDP the d dim of the lookup table
    elif name in _EXPERT and nd >= 3:
        if plan.expert_data_shard:
            baxes = tuple(plan.batch_axes)
            bsize = plan.axis_size(mesh, baxes)
            if not try_assign(-3, baxes if len(baxes) > 1 else baxes[0],
                              bsize):
                try_assign(-3, plan.batch_axes[-1],
                           plan.axis_size(mesh, plan.batch_axes[-1]))
            # per-expert TP: col for up/gate, row for down
            if name == "we_down":
                try_assign(-2, plan.tp_axis, tp)
            else:
                try_assign(-1, plan.tp_axis, tp)
            return P(*spec)
        try_assign(-3, plan.tp_axis, tp)               # experts over model
    elif name in _COL or name in _CROSS_COL:
        if not is_attn_leaf or head_ok:
            try_assign(-1, plan.tp_axis, tp)
        if plan.dense_2d_shard and name == "unembed":
            baxes = tuple(plan.batch_axes)
            try_assign(-2, baxes if len(baxes) > 1 else baxes[0],
                       plan.axis_size(mesh, baxes))
            return P(*spec)
    elif name in _ROW:
        if not is_attn_leaf or head_ok:
            try_assign(-2, plan.tp_axis, tp)

    # FSDP over the data axis for big leaves, on a spare dim
    if (plan.enable_fsdp and _nbytes(leaf) >= plan.fsdp_min_bytes
            and nd >= 2):
        for dim in (-2, -1, -3):
            if abs(dim) <= nd and try_assign(dim, fsdp_axis, fsdp):
                break
    return P(*spec)


def param_shardings(params, cfg: ArchConfig, mesh,
                    plan: Optional[MeshPlan] = None):
    plan = plan or MeshPlan()
    return map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, param_pspec(path, leaf, cfg, mesh, plan)), params)


def opt_state_shardings(opt_state, params_sh, mesh):
    """Adam's ``m``/``v`` and SGD's ``mu`` mirror the parameter shardings
    path by path; the step counter is replicated."""
    flat_params = dict(leaves_with_path(params_sh))
    repl = NamedSharding(mesh, P())
    out = {}
    for k, v in opt_state.items():
        if k == "step":
            out[k] = repl
        else:
            out[k] = map_with_path(
                lambda path, leaf: flat_params.get(path, repl), v)
    return out


def batch_shardings(batch, mesh, plan: Optional[MeshPlan] = None):
    """tokens/labels (B, S): batch over the batch axes when it divides;
    M-RoPE positions (3, B, S) shard dim 1."""
    plan = plan or MeshPlan()
    baxes = plan.batch_axes if len(plan.batch_axes) > 1 else plan.batch_axes[0]
    bsize = plan.axis_size(mesh, tuple(plan.batch_axes))

    def spec(path, leaf):
        shape = _shape(leaf)
        nd = len(shape)
        bdim = 1 if (nd == 3 and shape[0] == 3) else 0
        s = [None] * nd
        if shape[bdim] % bsize == 0 and bsize > 1:
            s[bdim] = baxes
        return NamedSharding(mesh, P(*s))

    return map_with_path(spec, batch)


def cache_shardings(cache, cfg: ArchConfig, mesh,
                    plan: Optional[MeshPlan] = None):
    """KV caches (R, B, S, K, hd) / (R, B, S, r): batch over data when it
    divides, otherwise sequence over data (the long_500k batch-1 path);
    kv heads over model when they divide."""
    plan = plan or MeshPlan()
    baxes = plan.batch_axes if len(plan.batch_axes) > 1 else plan.batch_axes[0]
    bsize = plan.axis_size(mesh, tuple(plan.batch_axes))
    tp_in_batch = plan.tp_axis in plan.batch_axes
    tp = (plan.axis_size(mesh, plan.tp_axis)
          if plan.enable_tp and not tp_in_batch else 1)

    all_axes = (tuple(plan.batch_axes) if tp_in_batch
                else tuple(plan.batch_axes) + (plan.tp_axis,))

    def axis_prod(axes):
        out = 1
        for a in axes:
            out *= mesh.shape[a]
        return out

    def spec(path, leaf):
        name = _leaf_name(path)
        shape = _shape(leaf)
        nd = len(shape)
        s = [None] * nd
        if name in ("k", "v", "xk", "xv") and nd == 5:
            R, B, S, K, hd = shape
            kv_shardable = K % tp == 0 and tp > 1
            if B % bsize == 0 and bsize > 1:
                s[1] = baxes
                if kv_shardable:
                    s[3] = plan.tp_axis
                elif S % tp == 0 and tp > 1:
                    s[2] = plan.tp_axis
            else:
                # batch not fully shardable: a leading subset of the batch
                # axes for B, the rest for S (whisper's cross-kv path), then
                # pure sequence sharding (the long_500k batch-1 path)
                done = False
                for i in range(len(plan.batch_axes) - 1, 0, -1):
                    head = plan.batch_axes[:i]
                    tail = plan.batch_axes[i:]
                    if B % axis_prod(head) == 0 and axis_prod(head) > 1:
                        s[1] = head if len(head) > 1 else head[0]
                        if S % axis_prod(tail) == 0:
                            s[2] = tail if len(tail) > 1 else tail[0]
                        elif K % axis_prod(tail) == 0:
                            s[3] = tail if len(tail) > 1 else tail[0]
                        done = True
                        break
                if not done:
                    if not kv_shardable and S % (bsize * tp) == 0:
                        s[2] = all_axes
                    elif S % bsize == 0 and bsize > 1:
                        s[2] = baxes
                        if kv_shardable:
                            s[3] = plan.tp_axis
        elif name in ("ckv", "krope") and nd == 4:
            R, B, S, r = shape
            if B % bsize == 0 and bsize > 1:
                s[1] = baxes
                if S % tp == 0 and tp > 1:
                    s[2] = plan.tp_axis
            elif S % (bsize * tp) == 0:
                s[2] = all_axes
            elif S % bsize == 0 and bsize > 1:
                s[2] = baxes
        else:
            # recurrent states: (R, B, ...) batch over data when divisible
            if nd >= 2 and shape[1] % bsize == 0 and bsize > 1:
                s[1] = baxes
            # shard the big inner dim of mamba/mlstm states over model
            if nd >= 3 and shape[2] % tp == 0 and tp > 1 \
                    and name in ("h", "C", "n", "conv"):
                dim = 2 if name != "conv" else nd - 1
                if shape[dim] % tp == 0:
                    s[dim] = plan.tp_axis
        return NamedSharding(mesh, P(*s))

    return map_with_path(spec, cache)


def replicated(tree, mesh):
    return map_with_path(lambda path, leaf: NamedSharding(mesh, P()), tree)


# -- cohort (stacked K-client) trees ----------------------------------------
#
# The cohort engine (repro_torch.fl.cohort) keeps K client models stacked
# as one tree with a leading client axis.  Its layout is two rules: that
# leading axis splits over the ``clients`` mesh axis, and, on a 2-D
# (clients, data) mesh, a designated sample dim of the batch arrays splits
# over ``data`` while the client models are copied to every device of
# their group.


def cohort_pspec(axis: str = "clients", data_axis: Optional[str] = None,
                 data_dim: Optional[int] = None) -> P:
    """Spec of a stacked-cohort array: leading client axis over ``axis``;
    with ``data_axis`` and ``data_dim``, that dim also over the data axis
    (dim 2 of train batches (K, T, B, ...), dim 1 of eval shards (K, N,
    ...)).  Parameters never take a data dim."""
    if data_axis is None or data_dim is None:
        return P(axis)
    if data_dim < 1:
        raise ValueError(f"data_dim must be >= 1 (got {data_dim}); dim 0 is "
                         "the client axis")
    return P(axis, *([None] * (data_dim - 1)), data_axis)


def _check_axis(mesh, axis: str) -> None:
    if axis not in mesh.shape:
        raise ValueError(f"mesh {tuple(mesh.axis_names)} has no {axis!r} axis")


def cohort_batch_sharding(mesh, axis: str = "clients",
                          data_axis: Optional[str] = None,
                          data_dim: Optional[int] = None) -> NamedSharding:
    """Sharding of a cohort batch array (xb/yb/mask): the client axis over
    ``axis``; on a 2-D mesh, ``data_dim`` over ``data_axis``."""
    _check_axis(mesh, axis)
    if data_axis is not None:
        _check_axis(mesh, data_axis)
    return NamedSharding(mesh, cohort_pspec(axis, data_axis, data_dim))


def data_shard_sharding(mesh, data_axis: str = "data",
                        dim: int = 0) -> NamedSharding:
    """Sharding of an array with no client axis whose ``dim`` splits over
    the data axis (the shared validation shard of a tip sweep, the batch
    rows' weights)."""
    _check_axis(mesh, data_axis)
    return NamedSharding(mesh, P(*([None] * dim), data_axis))


def stacked_client_shardings(stacked, mesh, axis: str = "clients",
                             data_axis: Optional[str] = None):
    """Shardings of a ``tree_stack``-ed K-client tree: every leaf's leading
    K axis over ``axis``.  On a 2-D mesh the parameters stay whole on each
    device of a client group; ``data_axis`` is checked so callers can pass
    their full mesh through one place."""
    _check_axis(mesh, axis)
    if data_axis is not None:
        _check_axis(mesh, data_axis)
    return map_with_path(
        lambda path, leaf: NamedSharding(mesh, cohort_pspec(axis)), stacked)
