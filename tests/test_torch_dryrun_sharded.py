"""The dry run's sharded count (``launch.dryrun`` on DTensors over a fake
process group) against hand counts and against the reference's
partitioned HLO.

Hand counts first, on a (4, 2) fake mesh: a column- then row-parallel
MLP (its per-chip FLOPs and its one all-reduce), a pure data-parallel
training step (its all-reduce is the float32 gradient's bytes), the sLSTM
region (its collectives do not grow with the sequence: the gate weights'
gradient is reduced once, after the loop), an AdamW step on sharded
leaves (no collective), and the folded step loops (equal to the loops run
step by step: FLOPs, bytes, operations and collectives).  Every leaf the
dry run places holds the block the sharding rules give it.

The sites of ``sharding.dtensor`` that place a block by the chip's
coordinate (a fused projection's halves, the kv heads of a chip's query
groups, a chip's experts and tokens, a sequence-sharded cache's slot,
the microbatches) give every chip its own block on a (4, 2) mesh of
threads whose collectives move data (``launch.mesh.run_on_chips``), and
a count over tensors that hold values runs the step loops unfolded; the
DTensor paths' own arithmetic (the softmax across key shards, the
vocab-blocked cross-entropy and argmax) equals the plain paths' on plain
tensors.

Then the five reduced cases of ``tests/test_dryrun_small.py`` (and
xlstm-125m) against the reference's ``analyze_hlo`` of the same step
partitioned on 4 x 2 forced host devices, which the reference computes
in a subprocess started with the module (only these need JAX): per-chip
FLOPs within 10%, the collective kinds the reference's apart from the
named differences of DTensor's plan (:data:`KIND_DIFFERENCES`), and
their total bytes within 2x.  The ratios, and the port's peak bytes
over the reference's temp bytes, are recorded as JUnit properties.

Every test leaves no process group initialised.
"""
import dataclasses
import functools
import importlib.util
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.tensor import (Replicate, Shard,  # noqa: E402
                                      distribute_tensor)

from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, get_config,  # noqa: E402
                                 reduced)
from repro_torch.configs.base import InputShape, Stage  # noqa: E402
from repro_torch.launch import cost_analysis, dryrun  # noqa: E402
from repro_torch.launch.cost_analysis import CostCount  # noqa: E402
from repro_torch.launch.mesh import (dtensor_mesh, make_host_mesh,  # noqa: E402
                                     make_production_mesh, run_on_chips)
from repro_torch.models import attention, xlstm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim.optimizers import adamw, apply_updates  # noqa: E402
from repro_torch.runtime import Runtime  # noqa: E402
from repro_torch.sharding import dtensor  # noqa: E402
from repro_torch.sharding.rules import (MeshPlan,  # noqa: E402
                                        cache_shardings, leaves_with_path,
                                        opt_state_shardings, param_shardings,
                                        small_model_plan)

REPO = os.path.join(os.path.dirname(__file__), "..")
CASES = [("internlm2-1.8b", "train", 8, 64),
         ("jamba-v0.1-52b", "train", 8, 64),
         ("xlstm-125m", "train", 8, 64),
         ("deepseek-v2-236b", "decode", 8, 128),
         ("whisper-medium", "prefill", 8, 64)]

_REFERENCE = r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, sys
import numpy as np
import jax
from jax.sharding import Mesh
sys.path.insert(0, "src")
from repro.configs import get_config, reduced
from repro.configs.base import InputShape
from repro.launch import dryrun
from repro.launch.hlo_analysis import analyze_hlo
from repro.sharding.rules import MeshPlan

out = {}
mesh = Mesh(np.asarray(jax.devices()).reshape(4, 2), ("data", "model"))
for arch, mode, batch, seq in CASES:
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              compute_dtype="bfloat16",
                              cache_dtype="bfloat16")
    jitted, args = dryrun.build_step(cfg, InputShape("test", seq, batch, mode),
                                     mesh, MeshPlan())
    with mesh:
        compiled = jitted.lower(*args).compile()
        cost = analyze_hlo(compiled.as_text())
        temp = int(compiled.memory_analysis().temp_size_in_bytes)
    out[arch] = {"flops": cost.flops, "colls": dict(cost.colls),
                 "temp": temp}
print(json.dumps(out))
'''


# The collective kinds the port's plan has and the reference's has not
# (extra) or the other way round (missing), by case; every other kind is
# in both or in neither.  A fused projection's halves move as XLA moves
# them, a collective-permute forward and an all-to-all backward
# (``sharding.dtensor.halves``).  Where XLA all-reduces a partial sum,
# DTensor reduce-scatters some onto a sharded dim: Mamba's dt projection
# onto its channels (``summed_onto_features``), FSDP gradients onto their
# shards (``gradient_placed``), the mLSTM's gate sums onto its heads
# (``on_chips``), MLA decode's values onto the heads, and the vocab-sharded
# embedding's lookup onto the sequence, which the batch constraint then
# gathers (whisper's all-gather).
KIND_DIFFERENCES = {
    "internlm2-1.8b": (set(), set()),
    "jamba-v0.1-52b": ({"reduce-scatter"}, set()),
    "xlstm-125m": ({"reduce-scatter"}, set()),
    "deepseek-v2-236b": ({"reduce-scatter"}, set()),
    "whisper-medium": ({"all-gather", "reduce-scatter"}, set()),
}


@pytest.fixture(scope="module", autouse=True)
def reference_run():
    """The reference's counts, computed in a subprocess that starts with
    the module and runs beside its other tests (None without JAX)."""
    if importlib.util.find_spec("jax") is None:
        yield None
        return
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", f"CASES = {CASES!r}\n" + _REFERENCE],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=env)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref(reference_run):
    pytest.importorskip("jax")
    out, err = reference_run.communicate(timeout=900)
    assert reference_run.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(autouse=True)
def no_group_left():
    yield
    assert not dist.is_initialized()


def _host_mesh():
    return make_host_mesh(4, 2, devices=[torch.device("meta")] * 8)


def _cfg(arch, slstm=False):
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              compute_dtype="bfloat16",
                              cache_dtype="bfloat16")
    if slstm:      # the reduced xLSTM keeps two mLSTM blocks: add the sLSTM
        pattern = get_config(arch).stages[0].pattern[-2:]
        cfg = dataclasses.replace(cfg, stages=(Stage(pattern, 1),))
    return cfg


def _sharded_count(cfg, mode, batch, seq, plan=None):
    mesh = _host_mesh()
    with dtensor_mesh(mesh) as dmesh, \
            FakeTensorMode(allow_non_fake_inputs=True):
        step, _, _ = dryrun.build_step(cfg, InputShape("t", seq, batch, mode),
                                       mesh, plan or MeshPlan(), dmesh)
        with CostCount() as cost:
            step()
    return cost


# -- the mesh and the placements ----------------------------------------------


def test_dtensor_mesh_has_the_axes_and_leaves_no_group():
    mesh = make_production_mesh(multi_pod=True,
                                devices=[torch.device("meta")] * 512)
    with dtensor_mesh(mesh) as dmesh:
        assert dist.is_initialized()
        assert dmesh.mesh_dim_names == ("pod", "data", "model")
        assert tuple(dmesh.shape) == (2, 16, 16)
        with pytest.raises(RuntimeError):
            with dtensor_mesh(mesh):
                pass
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        with dtensor_mesh(mesh):
            raise ValueError
    assert not dist.is_initialized()


def test_placements_shard_major_to_minor_and_refuse_other_orders():
    from repro_torch.sharding.rules import P, dtensor_placements
    mesh = make_production_mesh(multi_pod=True,
                                devices=[torch.device("meta")] * 512)
    with dtensor_mesh(mesh) as dmesh:
        assert dtensor_placements(P(("pod", "data"), None, "model"),
                                  dmesh) == [Shard(0), Shard(0), Shard(2)]
        assert dtensor_placements(P(None, "data"), dmesh) == [
            Replicate(), Shard(1), Replicate()]
        with pytest.raises(ValueError):
            dtensor_placements(P(("data", "pod")), dmesh)


def _check_blocks(trees, shardings, dmesh):
    for tree, sh in zip(trees, shardings):
        placed = dict(leaves_with_path(dryrun.place(tree, sh, dmesh)))
        for path, s in leaves_with_path(sh):
            leaf = placed[path]
            if isinstance(leaf, torch.Tensor):
                assert tuple(leaf.to_local().shape) == s.shard_shape(
                    leaf.shape), path


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_leaf_holds_its_rule_block(arch):
    """Parameters and optimizer state under the training plan, parameters
    and caches under the decode plan, on the (16, 16) mesh, for the
    baseline and the auto plan."""
    cfg = get_config(arch)
    mesh = make_production_mesh(devices=[torch.device("meta")] * 256)
    train, decode = INPUT_SHAPES["train_4k"], INPUT_SHAPES["decode_32k"]
    with dtensor_mesh(mesh) as dmesh, FakeTensorMode():
        params = tfm.init_params(torch.Generator(), cfg)
        opt_state = adamw(1e-3).init(params)
        caches = tfm.init_cache(cfg, decode.global_batch, decode.seq_len)
        for plan_mode in ("baseline", "auto"):
            plan = dryrun.make_plan(cfg, False, plan_mode, train)
            params_sh = param_shardings(params, cfg, mesh, plan)
            _check_blocks([params, opt_state],
                          [params_sh, opt_state_shardings(
                              opt_state, params_sh, mesh)], dmesh)
            plan = dryrun.make_plan(cfg, False, plan_mode, decode)
            _check_blocks([params, caches],
                          [param_shardings(params, cfg, mesh, plan),
                           cache_shardings(caches, cfg, mesh, plan)], dmesh)


# -- hand counts --------------------------------------------------------------


def test_column_then_row_parallel_mlp_hand_count():
    """x (8, 16) over data, W1 (16, 32) column-parallel, W2 (32, 16)
    row-parallel over model: per chip two (2, 16) x (16, 16) products and
    one all-reduce of the (2, 16) float32 output."""
    with dtensor_mesh(_host_mesh()) as dmesh, FakeTensorMode():
        x = distribute_tensor(torch.empty(8, 16), dmesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        w1 = distribute_tensor(torch.empty(16, 32), dmesh,
                               [Replicate(), Shard(1)], src_data_rank=None)
        w2 = distribute_tensor(torch.empty(32, 16), dmesh,
                               [Replicate(), Shard(0)], src_data_rank=None)
        with CostCount() as cost:
            y = (torch.relu(x @ w1) @ w2).redistribute(
                dmesh, [Shard(0), Replicate()])
        assert tuple(y.to_local().shape) == (2, 16)
    assert cost.flops == 2 * (2 * 2 * 16 * 16)
    assert cost.bytes == 2 * 4 * (2 * 16 + 16 * 16 + 2 * 16)
    assert dict(cost.colls) == {"all-reduce": 4 * 2 * 16}


def test_data_parallel_step_all_reduces_the_gradient_bytes():
    """``small_model_plan`` on the (4, 2) mesh: the batch over both axes,
    no tensor parallelism, no FSDP; the step's collectives are each
    float32 gradient's all-reduce over all eight chips and the Eq. 3
    signature's, its d_model float32 per-channel counts summed over the
    chips once."""
    cfg = _cfg("internlm2-1.8b")
    plan = small_model_plan(("data",), "model", cfg.param_count())
    assert not plan.enable_tp and not plan.enable_fsdp
    with FakeTensorMode():
        grad_bytes = sum(4 * leaf.numel() for _, leaf in leaves_with_path(
            tfm.init_params(torch.Generator(), cfg)))
    cost = _sharded_count(cfg, "train", 8, 64, plan)
    assert dict(cost.colls) == {"all-reduce": grad_bytes + 4 * cfg.d_model}


@pytest.mark.parametrize("seq", [8, 16])
def test_slstm_region_reduces_the_gate_gradient_once(seq):
    """The sLSTM recurrence on each chip's rows, its gate weights
    replicated into the region: forward and backward, the gradient placed
    as the weights are.  The collectives are the weights' one all-reduce
    over the batch axis, whatever the sequence length."""
    cfg = _cfg("xlstm-125m", slstm=True)
    d = cfg.d_model
    runtime = Runtime(batch_axes=("data",), batch_axis_size=4)
    with dtensor_mesh(_host_mesh()) as dmesh, FakeTensorMode():
        params = xlstm.init_slstm(torch.Generator(), cfg, torch.float32)
        rows, whole = [Shard(0), Replicate()], [Replicate(), Replicate()]
        used = {k: distribute_tensor(params[k], dmesh, whole,
                                     src_data_rank=None).requires_grad_()
                for k in ("w_gates", "r_gates", "b_gates")}
        xconv = distribute_tensor(torch.empty(8, seq, d), dmesh, rows,
                                  src_data_rank=None).requires_grad_()
        state = xlstm.init_slstm_state(cfg, 8)
        with CostCount() as cost:
            hs, _ = xlstm._slstm_scan_maybe_sharded(
                used, xconv, state,
                dataclasses.replace(runtime, dmesh=dmesh))
            hs.sum().backward()
            for p in used.values():
                p.grad.redistribute(dmesh, whole)
        assert tuple(hs.to_local().shape) == (2, seq, d)
    assert dict(cost.colls) == {"all-reduce": 4 * (2 * d * 4 * d + 4 * d)}


def test_adamw_step_on_sharded_leaves_adds_no_collective():
    """Parameters, gradients and moments placed alike, one leaf past the
    update's piece size on each chip: the update is local."""
    with dtensor_mesh(_host_mesh()) as dmesh, FakeTensorMode():
        def leaf(shape, placements):
            return distribute_tensor(torch.empty(shape), dmesh, placements,
                                     src_data_rank=None)
        layouts = {"big": ((1 << 14, 1 << 14), [Replicate(), Shard(1)]),
                   "fsdp": ((256, 64), [Shard(0), Shard(1)]),
                   "repl": ((64,), [Replicate(), Replicate()])}
        params = {k: leaf(*v) for k, v in layouts.items()}
        grads = {k: leaf(*v) for k, v in layouts.items()}
        assert params["big"].to_local().numel() > 1 << 26
        opt = adamw(1e-3, weight_decay=0.1)
        state = opt.init(params)
        with CostCount() as cost, torch.no_grad():
            updates, state = opt.update(grads, state, params)
            apply_updates(params, updates)
        assert all(p.placements == params[k].placements
                   for k, p in updates.direction.items())
    assert not cost.colls and cost.flops == 0


# -- folded step loops --------------------------------------------------------


def _unfolded(run, inputs, *_):
    return run(*inputs)


# metadata queries (``prim.device``, ``prim.layout``) and aliases
# (``detach``): the fold's own autograd node and its inner backward make
# some that the step-by-step loop does not
_NOT_OPERATIONS = {"device.default", "layout.default", "detach.default"}


def _operations(ops):
    return {k: v for k, v in ops.items() if k not in _NOT_OPERATIONS}


@pytest.mark.parametrize("mode,remat", [("train", True), ("train", False),
                                        ("prefill", True)])
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-125m"])
def test_folded_loops_count_as_unfolded(monkeypatch, record_property, arch,
                                        mode, remat):
    """The Mamba scan's and the sLSTM's step loops counted from two and
    three steps equal the loops counted step by step, on the (4, 2)
    mesh: FLOPs, bytes, operations (metadata queries and aliases apart)
    and collectives."""
    cfg = _cfg(arch, slstm=arch == "xlstm-125m")
    monkeypatch.setattr(dryrun, "Runtime",
                        functools.partial(Runtime, remat=remat))
    folded = _sharded_count(cfg, mode, 4, 8)
    monkeypatch.setattr(cost_analysis, "folded", _unfolded)
    unfolded = _sharded_count(cfg, mode, 4, 8)
    assert folded.flops == unfolded.flops > 0
    assert folded.bytes == unfolded.bytes
    assert _operations(folded.ops) == _operations(unfolded.ops)
    assert folded.colls == unfolded.colls
    # the peak is extrapolated, not counted: recorded beside the loops'
    record_property("peak_folded_over_unfolded",
                    folded.peak_bytes / unfolded.peak_bytes)
    assert folded.peak_bytes > 0


# -- each chip's own block, and the DTensor paths' arithmetic -----------------


def _cut(t, dmesh, placements):
    """The block of the plain tensor ``t`` this chip holds at
    ``placements``."""
    return distribute_tensor(t, dmesh, placements,
                             src_data_rank=None).to_local()


def _leaf(t, dmesh, placements):
    """The plain ``t`` placed as a DTensor leaf that takes a gradient."""
    return distribute_tensor(t.detach().clone(), dmesh, placements,
                             src_data_rank=None).requires_grad_()


def _halves(dm):
    """A fused projection's output (8, 3, 16), rows over data and
    features over model: each half's block and the input's gradient."""
    g = torch.Generator().manual_seed(0)
    t, wa, wb = (torch.randn(8, 3, 16, generator=g) for _ in range(3))
    wa, wb = wa[..., :8], wb[..., :8]
    place = [Shard(0), Shard(2)]
    plain = t.clone().requires_grad_()
    a, b = plain.chunk(2, dim=-1)
    ((a * wa).sum() + (b * wb).sum()).backward()
    leaf = _leaf(t, dm, place)
    got = dtensor.halves(leaf)
    for h, want in zip(got, (a, b)):
        assert h.placements == tuple(place)
        assert torch.equal(h.to_local(), _cut(want.detach(), dm, place))
    (got[0] * distribute_tensor(wa, dm, place, src_data_rank=None)
     + got[1] * distribute_tensor(wb, dm, place, src_data_rank=None)
     ).sum().backward()
    assert torch.equal(leaf.grad.to_local(), _cut(plain.grad, dm, place))


def _gqa(q, k, v):
    G = q.shape[2] // k.shape[2]
    k, v = (t.repeat_interleave(G, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)


def _kv_heads(dm):
    """Four query heads over model in two groups, the two kv heads
    replicated: each chip attends with its own groups' kv head."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(4, 5, 4, 8, generator=g)
    k, v = (torch.randn(4, 5, 2, 8, generator=g) for _ in range(2))
    heads, rows = [Shard(0), Shard(2)], [Shard(0), Replicate()]
    kp, vp = (t.clone().requires_grad_() for t in (k, v))
    want = _gqa(q, kp, vp)
    want.square().sum().backward()
    kl, vl = _leaf(k, dm, rows), _leaf(v, dm, rows)
    got = dtensor.attention_on_chips(
        _gqa, distribute_tensor(q, dm, heads, src_data_rank=None), kl, vl)
    assert got.placements == tuple(heads)
    assert torch.allclose(got.to_local(), _cut(want.detach(), dm, heads),
                          atol=1e-6)
    got.square().sum().backward()
    for leaf, plain in ((kl, kp), (vl, vp)):
        assert torch.allclose(leaf.grad.full_tensor(), plain.grad, atol=1e-5)


def _experts(dm):
    """One group of 8 tokens spread over data, 4 experts over model: each
    chip's share of the routing is its tokens' rows and its experts'."""
    g = torch.Generator().manual_seed(2)
    dispatch = torch.rand(1, 8, 4, 2, generator=g)
    gates = torch.rand(1, 8, 4, generator=g)
    x = distribute_tensor(torch.randn(4, 2, 3, generator=g), dm,
                          [Shard(0), Replicate()], src_data_rank=None)
    we = distribute_tensor(torch.randn(4, 3, generator=g), dm,
                           [Replicate(), Shard(0)], src_data_rank=None)

    def share(x, we):
        return dtensor.chips_share(dispatch, gates, we.shape[0],
                                   x.shape[0] * x.shape[1])

    held, gh = dtensor.on_chips(share, (x, we),
                                ({"batch": 0}, {"expert": 0}),
                                ({"batch": 1, "expert": 2},
                                 {"batch": 1, "expert": 2}))
    place = [Shard(1), Shard(2)]
    assert torch.equal(held.to_local(), _cut(dispatch, dm, place))
    assert torch.equal(gh.to_local(), _cut(gates, dm, place))


def _cache_slot(dm):
    """A cache (2, 16, 2, 8), sequence over data and kv heads over model:
    slot 9 is written by the chip whose block holds it, at 9 less its
    first slot; the other blocks stay as they were."""
    g = torch.Generator().manual_seed(3)
    cache = torch.randn(2, 16, 2, 8, generator=g)
    new = torch.randn(2, 2, 8, generator=g)
    place = [Shard(1), Shard(2)]
    sharded = distribute_tensor(cache.clone(), dm, place, src_data_rank=None)
    dtensor.write_slot(sharded, 9, distribute_tensor(
        new, dm, [Replicate(), Shard(1)], src_data_rank=None))
    want = cache.clone()
    want[:, 9] = new
    assert torch.equal(sharded.to_local(), _cut(want, dm, place))


def _microbatches(dm):
    """Rows over data cut into microbatches: each holds the reference's
    rows ``[i B/n, (i+1) B/n)``, sharded where the chips divide them and
    replicated where they do not; M-RoPE positions on axis 1; and the
    rows' gradient."""
    g = torch.Generator().manual_seed(4)
    for n, shape, axis in ((2, (8, 3), 0), (4, (8, 3), 0),
                           (4, (3, 8, 5), 1)):
        t = torch.randn(shape, generator=g)
        ws = torch.randn(shape, generator=g).chunk(n, dim=axis)
        place = [Shard(axis), Replicate()]
        plain = t.clone().requires_grad_()
        sum((p * w).sum() for p, w in zip(plain.chunk(n, dim=axis), ws)
            ).backward()
        leaf = _leaf(t, dm, place)
        got = dtensor.microbatches(leaf, axis, n)
        split = (shape[axis] // n) % 4 == 0
        for mb, want in zip(got, t.chunk(n, dim=axis)):
            assert mb.placements == tuple(place if split else [
                Replicate(), Replicate()])
            assert torch.equal(mb.full_tensor(), want)
            assert torch.equal(mb.to_local(), _cut(want, dm, mb.placements))
        sum((mb * distribute_tensor(w, dm, mb.placements,
                                    src_data_rank=None)).sum()
            for mb, w in zip(got, ws)).backward()
        assert torch.allclose(leaf.grad.full_tensor(), plain.grad)


_SITES = {"halves": _halves, "kv_heads": _kv_heads, "experts": _experts,
          "cache_slot": _cache_slot, "microbatches": _microbatches}


@pytest.mark.parametrize("site", sorted(_SITES))
def test_site_gives_each_chip_its_own_block(site):
    """Each site of ``sharding.dtensor`` that places a block by the
    chip's coordinate, on a (4, 2) mesh of threads whose collectives
    move data: every rank's block is the same cut of the unsharded
    operation, and for the halves and the microbatches so is the
    gradient."""
    mesh = make_host_mesh(4, 2, devices=[torch.device("cpu")] * 8)
    with torch.random.fork_rng():
        run_on_chips(_SITES[site], mesh)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-125m"])
def test_count_over_values_runs_the_loops_unfolded(arch):
    """A count over tensors that hold values takes the plain loops: the
    same logits, bit for bit, as outside the count."""
    cfg = dataclasses.replace(_cfg(arch, slstm=arch == "xlstm-125m"),
                              compute_dtype="float32")
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 9),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, _ = tfm.forward(params, {"tokens": tokens}, cfg)
        with CostCount() as cost:
            got, _ = tfm.forward(params, {"tokens": tokens}, cfg)
    assert cost.flops > 0
    assert torch.equal(got, want)


class _KeysSplit:
    """``sharding.dtensor`` as ``models.attention`` sees it, with every
    cache read as sequence-sharded: decode's softmax across key shards,
    run on plain tensors (one shard)."""

    def __getattr__(self, name):
        return getattr(dtensor, name)

    @staticmethod
    def seq_sharded(t):
        return True

    @staticmethod
    def write_slot(cache, pos, new):
        cache[:, pos] = new.to(cache.dtype)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-v2-236b"])
def test_softmax_across_key_shards_equals_the_softmax(monkeypatch, arch):
    """Decode's split-key softmax (``exp(s - m) @ v / sum exp(s - m)``, GQA
    and MLA) gives the plain softmax's logits over four decode steps, in
    float32."""
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              compute_dtype="float32",
                              cache_dtype="float32")
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 4),
                           generator=torch.Generator().manual_seed(1))

    def decode():
        caches = tfm.init_cache(cfg, 2, 8)
        with torch.no_grad():
            return torch.stack([tfm.decode_step(
                params, tokens[:, i:i + 1], caches, i, cfg)[0]
                for i in range(4)])

    want = decode()
    monkeypatch.setattr(attention, "dtensor", _KeysSplit())
    got = decode()
    assert torch.allclose(got, want, rtol=1e-5,
                          atol=1e-5 * float(want.abs().max()))


def test_vocab_blocks_give_the_cross_entropy_and_argmax():
    """The vocab-sharded loss's arithmetic on two blocks of 50 and 30
    (each block's logsumexp and label logit, then combined as the
    all-reduces would) and the blocked argmax (the first index of the
    maximum, ties included) on one block equal the plain ones."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(3, 5, 80, generator=g)
    logits[0, 0, [7, 61]] = 9.0               # a tie across the blocks
    labels = torch.randint(0, 80, (3, 5), generator=g)
    parts = [dtensor.blockwise_ce(logits[..., a:b], a, labels,
                                  lambda t, op="sum": t)
             for a, b in ((0, 50), (50, 80))]
    logz = torch.logaddexp(parts[0][0], parts[1][0])
    assert torch.allclose(logz, torch.logsumexp(logits, -1), atol=1e-5)
    assert torch.equal(parts[0][1] + parts[1][1],
                       logits.gather(-1, labels[..., None])[..., 0])
    idx = dtensor.blockwise_argmax(logits, 0, lambda t, op: t)
    assert torch.equal(idx, logits.argmax(-1))
    assert int(idx[0, 0]) == 7


# -- against the reference's partitioned HLO ----------------------------------


@pytest.mark.parametrize("arch,mode,batch,seq", CASES)
def test_sharded_count_matches_reference(ref, record_property, arch, mode,
                                         batch, seq):
    cost = _sharded_count(_cfg(arch), mode, batch, seq)
    want = ref[arch]
    ratio = cost.flops / want["flops"]
    record_property("flops_ratio", ratio)
    total = sum(want["colls"].values())
    record_property("collective_ratio",
                    cost.collective_bytes / total if total else None)
    for kind in set(cost.colls) | set(want["colls"]):
        record_property(f"{kind}_bytes",
                        [cost.colls.get(kind, 0.0), want["colls"].get(kind)])
    record_property("peak_over_temp", cost.peak_bytes / want["temp"])
    assert ratio == pytest.approx(1.0, abs=0.10)
    extra, missing = KIND_DIFFERENCES[arch]
    port = {k for k, v in cost.colls.items() if v > 0}
    theirs = {k for k, v in want["colls"].items() if v > 0}
    assert port - theirs == extra
    assert theirs - port == missing
    assert total / 2 <= cost.collective_bytes <= 2 * total
