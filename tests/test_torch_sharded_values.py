"""The sharded step with values: the port's train, prefill and decode
steps on a (4, 2) ``("data", "model")`` DTensor mesh of threads whose
collectives move data (``launch.mesh.run_on_chips``, the baseline plan)
against the reference's partitioned step run with values on a (4, 2)
mesh of 8 forced XLA:CPU host devices, and against the port's own step
unsharded.

Cases, float32 compute and caches, weights from the reference's
``PRNGKey`` carried over with ``params_from_numpy``, inputs from a numpy
seed: the five reduced cases of ``tests/test_torch_dryrun_sharded.py``
(internlm2 train, Jamba train, xLSTM train with its sLSTM block,
deepseek-v2 decode, whisper prefill), internlm2 training at 4
microbatches (2 rows each: replicated over the 4 data chips) and a
batch-1 internlm2 decode, whose cache is sequence-sharded over data.
Each decode writes slot 81 of a 128-slot cache filled with random
values: on the sequence-sharded cache the third data chip's block, at
its slot 17.

The reference runs in one subprocess for the module, started with it
(``XLA_FLAGS`` fixes the device count at JAX's first use); the weights,
inputs and caches reach it in a pickle, its outputs come back in one.
The port's cases run in one call of ``run_on_chips``, all eight chips'
results kept; the prefill with the serving runtime, whose kernels take
their plain versions on the CPU (flash's within 2e-5 of the dense
scores).  Tolerances, those of the single-device parity tests of
the same steps:

* logits and caches (prefill, decode): atol 2e-5
  (``tests/test_torch_transformer.py``, ``tests/test_torch_decode.py``);
  decode's greedy tokens equal;
* training: loss, cross-entropy, router loss and grad norm within 1e-5;
  AdamW's moments within 1e-5 of each leaf's largest, or one bfloat16
  step at it where the config keeps them in bfloat16 (Jamba's: the
  chips' float32 gradients, within 2e-6 of one device's, round to
  neighbouring bfloat16 values); the signature within one flag of a
  row's fraction (a flag at the tau boundary); parameters after the
  step within 3e-5, the single-device tolerance of the MoE case
  (``tests/test_torch_train.py::_train_steps_agree``, 1e-5 for the
  dense ones), for every case: measured, up to 2.3e-5 (internlm2's and
  the xLSTM's ``wq``), as AdamW's first step divides each gradient by
  its magnitude plus 1e-8, and for a gradient within a few 1e-8 the
  chips' other summation order moves the update by a visible share of
  the learning rate, 3e-4.

Against the port's own unsharded step the same tolerances hold: the
chips' float32 sums are other orders than one device's.

The card's sharded LM training leg cut to 2 layers
(``internlm2_train_2l``: ``chip_smoke.py``'s ``sharded_lm_train``, whose
AdamW m read 1.02e-5 of its scale there, at the reduced width with the
leg's 16 query heads of 128 over 8 KV heads) holds its m within 1e-5 of
each leaf's largest (measured: 2.0e-6 at most, ``wq``), and its new
parameters as that leg holds them (CLEAR_PARAMS, ``_params_over``):
within 2 x the learning rate, and within 2% of it where the gradient is
clear of AdamW's epsilon.  The flat 3e-5 does not hold there in any
float32 order: at one entry of layer 0's ``wdown`` the gradient is
-1.3e-9 in the reference and +1.9e-10 in the port's unsharded step, and
AdamW's lr x g / (|g| + 1e-8) moves the two 3.9e-5 apart (one entry of
``wo``: 3.1e-5); the sharded step is as far, 6.0e-5 and 3.0e-5.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import torch.distributed as dist  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.configs.base import Stage as JStage  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import InputShape, Stage  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, run_on_chips  # noqa: E402
from repro_torch.sharding import dtensor  # noqa: E402
from repro_torch.sharding.rules import MeshPlan, leaves_with_path  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

from test_torch_baselines import few_torch_threads  # noqa: E402,F401

REPO = os.path.join(os.path.dirname(__file__), "..")
# name: (arch, mode, batch, seq, microbatches)
CASES = {
    "internlm2_train": ("internlm2-1.8b", "train", 8, 64, 1),
    "jamba_train": ("jamba-v0.1-52b", "train", 8, 64, 1),
    "xlstm_train": ("xlstm-125m", "train", 8, 64, 1),
    "deepseek_decode": ("deepseek-v2-236b", "decode", 8, 128, 1),
    "whisper_prefill": ("whisper-medium", "prefill", 8, 64, 1),
    "internlm2_train_mb4": ("internlm2-1.8b", "train", 8, 64, 4),
    "internlm2_decode_seq": ("internlm2-1.8b", "decode", 1, 128, 1),
}
# each case's seed of its weights and inputs
SEEDS = {name: i for i, name in enumerate(sorted(CASES))}
# the card's sharded LM training leg cut to 2 layers
# (chip_smoke.py's sharded_lm_train), at the reduced width with the leg's
# attention layout: 16 query heads of 128 over 8 KV heads
CASES["internlm2_train_2l"] = ("internlm2-1.8b+heads", "train", 8, 64, 1)
SEEDS["internlm2_train_2l"] = len(SEEDS)
POS = 81
LOGITS, CACHE = 2e-5, 2e-5
SCALARS, MOMENTS, PARAMS = 1e-5, 1e-5, 3e-5
# cases whose new parameters are held as the card holds the same step
# (module docstring): the learning rate, and where a gradient is clear
CLEAR_PARAMS = {"internlm2_train_2l"}
LR, CLEAR_M, CLEAR_SHARE = 3e-4, 2e-7, 0.02

_CONFIG = r'''
def config(get_config, reduced, Stage, arch):
    """The reduced config in float32; the xLSTM's with its sLSTM block
    (``reduced`` keeps the pattern's first two blocks, both mLSTM); with
    "+heads", the published config's attention heads."""
    arch, heads = arch.split("+")[0], arch.endswith("+heads")
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              compute_dtype="float32",
                              cache_dtype="float32")
    if heads:
        full = get_config(arch)
        cfg = dataclasses.replace(cfg, n_heads=full.n_heads,
                                  n_kv_heads=full.n_kv_heads,
                                  head_dim=full.head_dim)
    if arch == "xlstm-125m":
        pattern = get_config(arch).stages[0].pattern[-2:]
        cfg = dataclasses.replace(cfg, stages=(Stage(pattern, 1),))
    return cfg
'''
exec(_CONFIG)

_REFERENCE = r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, pickle, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
sys.path.insert(0, "src")
from repro.configs import get_config, reduced
from repro.configs.base import InputShape, Stage
from repro.launch import dryrun
from repro.sharding.rules import MeshPlan
from repro.train.step import default_optimizer
''' + _CONFIG + r'''
with open(sys.argv[1], "rb") as f:
    world = pickle.load(f)
mesh = Mesh(np.asarray(jax.devices()).reshape(4, 2), ("data", "model"))
out = {}
for name, w in world.items():
    arch, mode, B, S, mb = w["case"]
    cfg = config(get_config, reduced, Stage, arch)
    plan = MeshPlan()
    if mb > 1:
        object.__setattr__(plan, "_microbatches", mb)
    jitted, _ = dryrun.build_step(cfg, InputShape("t", S, B, mode), mesh,
                                  plan)
    params = jax.tree_util.tree_map(jnp.asarray, w["params"])
    with mesh:
        if mode == "train":
            res = jitted(params, default_optimizer(cfg).init(params),
                         w["batch"])
        elif mode == "prefill":
            res = jitted(params, w["batch"])
        else:
            res = jitted(params, w["batch"]["token"], w["caches"],
                         np.int32(w["batch"]["pos"]))
    out[name] = jax.tree_util.tree_map(np.asarray, res)
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
'''


def _world(name: str) -> dict:
    """The case's weights (the reference's initialisation, numpy), inputs
    and decode caches, from seeds."""
    arch, mode, B, S, mb = CASES[name]
    jcfg = config(j_get_config, j_reduced, JStage, arch)
    seed = SEEDS[name]
    params = jax.tree_util.tree_map(
        np.asarray, jtfm.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.RandomState(seed)
    V = jcfg.vocab_size
    w = {"case": CASES[name], "params": params, "caches": None}
    if mode == "decode":
        w["batch"] = {"token": rng.randint(0, V, (B, 1)).astype(np.int32),
                      "pos": POS}
        w["caches"] = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(a.dtype),
            jtfm.init_cache(jcfg, B, S))
        return w
    w["batch"] = {"tokens": rng.randint(0, V, (B, S)).astype(np.int32)}
    if mode == "train":
        w["batch"]["labels"] = rng.randint(0, V, (B, S)).astype(np.int32)
    if jcfg.encoder is not None:
        w["batch"]["enc_embed"] = rng.standard_normal(
            (B, jcfg.encoder.n_ctx, jcfg.d_model)).astype(np.float32)
    return w


@pytest.fixture(scope="module")
def worlds():
    return {name: _world(name) for name in CASES}


@pytest.fixture(scope="module")
def reference_run(worlds):
    """The reference's partitioned steps, computed in a subprocess that
    starts with the module and runs beside the port's."""
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
        with open(src, "wb") as f:
            pickle.dump(worlds, f)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        proc = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, src, dst],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=REPO, env=env)
        yield proc, dst
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def ref(reference_run, sharded):
    proc, dst = reference_run
    _, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-3000:]
    with open(dst, "rb") as f:
        return pickle.load(f)


def _args(name, w, device="cpu"):
    """The port's config and ``build_step`` keywords of a case."""
    arch, mode, B, S, mb = w["case"]
    cfg = config(get_config, reduced, Stage, arch)
    plan = MeshPlan()
    if mb > 1:
        object.__setattr__(plan, "_microbatches", mb)
    batch = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
             for k, v in w["batch"].items()}
    kw = {"params": params_from_numpy(w["params"], device), "batch": batch}
    if w["caches"] is not None:
        kw["caches"] = params_from_numpy(w["caches"], device)
    return cfg, InputShape("t", S, B, mode), plan, kw


def _full(t):
    t = t.full_tensor() if dtensor.is_dtensor(t) else t
    return t.detach().clone()


def _named(mode, res, leaves, one) -> dict:
    """A step's outputs by name: the leaves of the new parameters
    (``p/...``) and moments (``m/...``, ``v/...``) and the metrics of a
    training step; the logits, caches (``c/...``) and a decode's tokens.
    ``leaves(tree)`` yields a tree's (path, value), ``one`` converts an
    output that is no tree."""
    out = {}
    if mode == "train":
        params, state, metrics = res
        for tag, tree in (("p", params), ("m", state["m"]),
                          ("v", state["v"])):
            out.update((f"{tag}/{path}", leaf) for path, leaf in leaves(tree))
        out.update({k: one(v) for k, v in metrics.items()})
        return out
    *tokens, logits, caches = res
    if tokens:
        out["tokens"] = one(tokens[0])
    out["logits"] = one(logits)
    out.update((f"c/{path}", leaf) for path, leaf in leaves(caches))
    return out


def _gathered(mode, res) -> dict:
    """The port's outputs by name, each gathered whole."""
    def leaves(tree):
        for path, leaf in leaves_with_path(tree):
            yield "/".join(map(str, path)), _full(leaf)
    return _named(mode, res, leaves, _full)


@pytest.fixture(scope="module")
def sharded(worlds, reference_run):
    """Every case on the (4, 2) mesh of threads, the prefill with the
    serving runtime's kernels: each chip's gathered outputs by case, the
    caller's arguments, and the shapes of the flash wrapper's calls."""
    from repro_torch.kernels import ops
    mesh = make_host_mesh(4, 2, devices=[torch.device("cpu")] * 8)
    setups = {name: _args(name, w) for name, w in worlds.items()}
    calls, real = [], ops.flash_attention

    def counted(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return real(q, k, v, **kw)

    def chip(dmesh):
        outs = {}
        for name, (cfg, shape, plan, kw) in setups.items():
            step, _, args = dryrun.build_step(
                cfg, shape, mesh, plan, dmesh,
                use_kernels=shape.mode == "prefill", **kw)
            if name.endswith("_seq"):      # (repeats, B, S, K, hd)
                assert any(p.is_shard(2)
                           for p in args[2][0]["l0"]["k"].placements)
            outs[name] = _gathered(shape.mode, step())
        return outs

    ops.flash_attention = counted
    try:
        results = run_on_chips(chip, mesh)
    finally:
        ops.flash_attention = real
    return results, setups, calls


@pytest.fixture(scope="module")
def unsharded(worlds):
    out = {}
    mesh = make_host_mesh(4, 2, devices=[torch.device("cpu")] * 8)
    for name, w in worlds.items():
        cfg, shape, plan, kw = _args(name, w)
        step, _, _ = dryrun.build_step(cfg, shape, mesh, plan, **kw)
        out[name] = _gathered(shape.mode, step())
    return out


def _np_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _np_leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _np_leaves(t, prefix + (i,))
    else:
        yield "/".join(map(str, prefix)), np.asarray(tree)


def _tolerance(name, key, want, dtype) -> float:
    """The absolute tolerance of output ``key`` (module docstring); a
    moment kept in bfloat16 within one bfloat16 step at its leaf's
    largest value."""
    if key in ("logits",) or key.startswith("c/"):
        return LOGITS if key == "logits" else CACHE
    if key == "signature":
        return 1 / (CASES[name][2] * CASES[name][3]) + 1e-7
    if key.startswith("p/"):
        return PARAMS
    if key[:2] in ("m/", "v/"):
        step = 2.0 ** -7 if dtype == torch.bfloat16 else MOMENTS
        return step * max(float(np.abs(want).max()), 1e-30)
    return SCALARS


def _agree(name, got: dict, want: dict):
    """``got`` (the port's sharded outputs) against ``want`` at the
    module's tolerances; every output over its tolerance is reported."""
    assert set(want) <= set(got), set(want) - set(got)
    over = []
    for k, w in want.items():
        dtype = got[k].dtype
        g = got[k].float().numpy()
        w = np.asarray(w, dtype=np.float32 if k != "tokens" else None)
        if k == "tokens":
            if not np.array_equal(g, w):
                over.append((k, "tokens differ"))
            continue
        if k.startswith("p/") and name in CLEAR_PARAMS:
            n_over, n_clear = _params_over(g, w, np.asarray(want["m/" + k[2:]],
                                                            np.float32))
            if n_over or not n_clear:
                over.append((k, n_over, n_clear))
            continue
        err = float(np.abs(np.asarray(g, np.float32) - w).max())
        tol = _tolerance(name, k, w, dtype)
        if not err <= tol:
            over.append((k, err, tol))
    assert not over, over


def _params_over(got, want, m):
    """(entries over their tolerance, entries whose gradient is clear) of
    a leaf's new parameters, as ``chip_smoke.py``'s sharded training legs
    hold them: within 2 x LR everywhere, and within CLEAR_SHARE of LR plus
    two float32 steps where the reference's m is at least twice the m
    tolerance of its leaf's largest and CLEAR_M (the gradient at least 100
    x AdamW's epsilon of 1e-8, of one sign in both steps)."""
    d = np.abs(got - want)
    clear = np.abs(m) >= max(2 * MOMENTS * float(np.abs(m).max()), CLEAR_M)
    over = (d > 2 * LR) | (clear & (d > CLEAR_SHARE * LR
                                    + 2.0 ** -22 * np.abs(want)))
    return int(over.sum()), int(clear.sum())


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_matches_reference(name, sharded, ref):
    """The port's sharded step equals the reference's partitioned step
    run with values on 8 forced host devices."""
    got = sharded[0][0][name]
    _agree(name, got, _named(CASES[name][1], ref[name], _np_leaves,
                             np.asarray))


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_matches_unsharded(name, sharded, unsharded):
    """The port's sharded step equals its own step on one device."""
    _agree(name, sharded[0][0][name],
           {k: v.float().numpy() for k, v in unsharded[name].items()})


def test_every_chip_gathers_the_same_outputs(sharded):
    """Each chip's ``full_tensor`` of every output is the same tensor."""
    results = sharded[0]
    for name in CASES:
        for k, v in results[0][name].items():
            for r in results[1:]:
                assert torch.equal(r[name][k], v), (name, k)


def test_caller_arguments_are_untouched(sharded, worlds):
    """Each chip's blocks are copies: the in-place optimizer update and
    the cache writes left the caller's weights and caches as they were."""
    setups = sharded[1]
    for name, (_, _, _, kw) in setups.items():
        for tree in ("params", "caches"):
            for path, leaf in leaves_with_path(kw.get(tree, {})):
                want = worlds[name][tree]
                for key in path:
                    want = want[key]
                assert np.array_equal(leaf.numpy(), want), (name, path)


def test_flash_runs_once_a_chip_and_layer(sharded):
    """The sharded prefill takes the serving runtime's kernels on each
    chip's block (their plain versions on the CPU): the flash wrapper is
    called once a chip and attention layer of whisper's decoder, at one
    chip's (batch, heads) block, its calls counted across the threads."""
    cfg = config(get_config, reduced, Stage, "whisper-medium")
    calls = sharded[2]
    assert len(calls) == 8 * cfg.n_layers
    assert set(calls) == {(2, 64, cfg.n_heads // 2, cfg.head_dim)}


def test_a_failing_chip_fails_the_call_and_leaves_no_group():
    """An exception on one chip fails the call, whose other chips wait in
    a collective; a chip still running at the time limit fails it too;
    no process group is left initialised, and a later call runs."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = make_host_mesh(4, 2, devices=[torch.device("cpu")] * 8)
    x = torch.arange(16.0).reshape(8, 2)

    def gather(dmesh):
        return distribute_tensor(x, dmesh, [Shard(0), Replicate()],
                                 src_data_rank=None).full_tensor()

    def one_fails(dmesh):
        if dmesh.get_rank() == 5:
            raise ValueError("chip 5")
        return gather(dmesh)

    with pytest.raises(RuntimeError, match="chip 5 of 8 failed"):
        run_on_chips(one_fails, mesh)
    assert not dist.is_initialized()

    def one_waits(dmesh):
        if dmesh.get_rank() == 2:
            import time
            time.sleep(3)
        return gather(dmesh)

    with pytest.raises(TimeoutError):
        run_on_chips(one_waits, mesh, timeout=1.0)
    assert not dist.is_initialized()
    assert all(torch.equal(t, x) for t in run_on_chips(gather, mesh))
    assert not dist.is_initialized()


def test_each_rank_runs_on_its_mesh_device():
    """Rank ``r`` computes on ``mesh.devices.flat[r]``, in the caller's
    grad mode."""
    mesh = make_host_mesh(2, 2, devices=[torch.device("cpu")] * 4)

    def where(dmesh):
        return (dmesh.get_rank(), dmesh.device_type,
                torch.is_grad_enabled())

    with torch.no_grad():
        got = run_on_chips(where, mesh)
    assert got == [(r, "cpu", False) for r in range(4)]


def test_chips_take_turns_so_shared_counts_add_up():
    """More chips than cores, a short switch interval, and every chip
    adding to one module-level count between collectives, as the
    kernels' launch counters are added to: the chips take turns, so no
    read-modify-write is lost, and the call ends within its time limit."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.kernels import signature
    mesh = make_host_mesh(4, 4, devices=[torch.device("cpu")] * 16)
    steps = 200
    before, interval = signature.launches, sys.getswitchinterval()

    def chip(dmesh):
        x = distribute_tensor(torch.ones(4), dmesh,
                              [Replicate(), Replicate()],
                              src_data_rank=None)
        for i in range(steps):
            n = signature.launches
            for _ in range(50):
                pass
            signature.launches = n + 1
            if i % 50 == 0:
                x = x + x.full_tensor().sum()
        return float(x.full_tensor()[0])

    sys.setswitchinterval(1e-6)
    try:
        got = run_on_chips(chip, mesh, timeout=120.0)
    finally:
        sys.setswitchinterval(interval)
        added, signature.launches = signature.launches - before, before
    assert added == 16 * steps
    assert len(set(got)) == 1


def test_the_wrapped_waits_are_checked_before_a_run():
    """The torch internals whose waits give the chips' turn up are
    checked by their leading parameters: the installed torch's pass, and
    a renamed or reshaped one fails at once rather than in a run whose
    threads would wait holding the turn."""
    import types

    from torch.distributed import distributed_c10d
    from torch.testing._internal.distributed import multi_threaded_pg

    from repro_torch.launch.mesh import _blocking_wait
    for owner, attr in ((multi_threaded_pg.Collective, "join"),
                        (multi_threaded_pg, "_store_based_barrier"),
                        (distributed_c10d, "_store_based_barrier")):
        assert _blocking_wait(owner, attr) is getattr(owner, attr)
    for owner in (types.SimpleNamespace(),
                  types.SimpleNamespace(join=lambda self, data: None)):
        with pytest.raises(RuntimeError, match="blocking wait"):
            _blocking_wait(owner, "join")


def test_row_counts_sum_each_chips_rows():
    """The signature's counts of an activation sharded over batch and
    sequence: each chip counts its block, and the sum over the chips is
    the whole activation's count on every chip, with its row count."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.kernels import ops
    mesh = make_host_mesh(4, 2, devices=[torch.device("cpu")] * 8)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 6, 16)).astype(np.float32))
    want = ops.signature_counts(x.reshape(1, -1, 16), 0.05)[0]

    def chip(dmesh):
        t = distribute_tensor(x.clone(), dmesh, [Shard(0), Shard(1)],
                              src_data_rank=None)
        counts, rows = dtensor.row_counts(
            lambda r: ops.signature_counts(r[None], 0.05)[0], t)
        return counts, rows

    for counts, rows in run_on_chips(chip, mesh):
        assert rows == 48
        assert torch.equal(counts, want)
    assert dtensor.row_counts(
        lambda r: ops.signature_counts(r[None], 0.05)[0], x)[1] == 48
