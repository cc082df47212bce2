"""The port's sharding rules against ``repro.sharding.rules``, leaf by leaf.

Every config of ``ARCH_IDS`` on the (16, 16) and (2, 16, 16) production
meshes under four plans (the baseline, ``small_model_plan``, the decode
plan and ``attn_tp=False``): parameter, optimizer-state, batch and cache
specs equal the reference's, and so do the blocks one device holds.  The
reference side runs on ``jax.sharding.AbstractMesh`` over
``jax.eval_shape`` trees; the port's trees are built under
``FakeTensorMode`` (shapes only, nothing allocated).  Specs are compared
as tuples: exact equality, no tolerance.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import NamedSharding as JNamedSharding  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro.sharding import rules as j_rules  # noqa: E402
from repro.train.step import default_optimizer as j_default_optimizer  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_production_mesh  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.train.step import default_optimizer  # noqa: E402

MESHES = {"single_pod": False, "multi_pod": True}
PLANS = ("baseline", "small", "decode", "no_attn_tp")

_FAKE = FakeTensorMode()


def _meshes(multi_pod):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    port = make_production_mesh(
        multi_pod=multi_pod,
        devices=[torch.device("meta")] * int(np.prod(shape)))
    return port, AbstractMesh(shape, axes)


def _plans(name, cfg, multi_pod):
    """(port plan, reference plan) of one kind."""
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    if name == "small":
        return (rules.small_model_plan(batch_axes, "model",
                                       cfg.param_count()),
                j_rules.small_model_plan(batch_axes, "model",
                                         cfg.param_count()))
    kw = {"batch_axes": batch_axes}
    if name == "decode":
        kw.update(enable_fsdp=False, expert_data_shard=cfg.moe is not None,
                  dense_2d_shard=True)
    elif name == "no_attn_tp":
        kw.update(attn_tp=False)
    return rules.MeshPlan(**kw), j_rules.MeshPlan(**kw)


def _jpath(path):
    out = []
    for e in path:
        if isinstance(e, jax.tree_util.DictKey):
            out.append(str(e.key))
        elif isinstance(e, jax.tree_util.SequenceKey):
            out.append(e.idx)
        else:
            raise TypeError(e)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """(port params and AdamW state, reference params and AdamW state),
    shapes only."""
    jcfg = j_get_config(arch)
    jparams = jax.eval_shape(lambda k: j_tfm.init_params(k, jcfg),
                             jax.random.PRNGKey(0))
    jopt = jax.eval_shape(j_default_optimizer(jcfg).init, jparams)
    cfg = get_config(arch)
    with _FAKE:
        params = tfm.init_params(torch.Generator(), cfg)
        opt = default_optimizer(cfg).init(params)
    return params, opt, jparams, jopt


def _assert_same(port_sh, ref_sh, port_tree):
    """Equal paths, specs and per-device blocks, leaf by leaf."""
    port = dict(rules.leaves_with_path(port_sh))
    leaves = dict(rules.leaves_with_path(port_tree))
    ref = {_jpath(p): s for p, s in jax.tree_util.tree_flatten_with_path(
        ref_sh, is_leaf=lambda x: isinstance(x, JNamedSharding))[0]}
    assert port.keys() == ref.keys()
    for path, sh in port.items():
        assert tuple(sh.spec) == tuple(ref[path].spec), path
        if path in leaves and hasattr(leaves[path], "shape"):
            shape = tuple(leaves[path].shape)
            assert sh.shard_shape(shape) == ref[path].shard_shape(shape), path


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_state_specs_equal_reference(arch, mesh, plan):
    params, opt, jparams, jopt = _trees(arch)
    tmesh, jmesh = _meshes(MESHES[mesh])
    tplan, jplan = _plans(plan, get_config(arch), MESHES[mesh])
    cfg, jcfg = get_config(arch), j_get_config(arch)
    psh = rules.param_shardings(params, cfg, tmesh, tplan)
    jpsh = j_rules.param_shardings(jparams, jcfg, jmesh, jplan)
    _assert_same(psh, jpsh, params)
    osh = rules.opt_state_shardings(opt, psh, tmesh)
    josh = j_rules.opt_state_shardings(jopt, jpsh, jmesh)
    assert set(osh) == set(josh) == {"step", "m", "v"}
    assert tuple(osh["step"].spec) == tuple(josh["step"].spec) == ()
    for k in ("m", "v"):
        _assert_same(osh[k], josh[k], opt[k])


@pytest.mark.parametrize("mesh", MESHES)
def test_sgd_momentum_state_mirrors_params(mesh):
    """SGD's ``mu`` takes the parameters' specs, as Adam's moments do."""
    from repro.optim.optimizers import sgd as j_sgd
    from repro_torch.optim.optimizers import sgd
    params, _, jparams, _ = _trees("internlm2-1.8b")
    tmesh, jmesh = _meshes(MESHES[mesh])
    cfg, jcfg = get_config("internlm2-1.8b"), j_get_config("internlm2-1.8b")
    with _FAKE:
        opt = sgd(0.1, momentum=0.9).init(params)
    jopt = jax.eval_shape(j_sgd(0.1, momentum=0.9).init, jparams)
    psh = rules.param_shardings(params, cfg, tmesh)
    jpsh = j_rules.param_shardings(jparams, jcfg, jmesh)
    osh = rules.opt_state_shardings(opt, psh, tmesh)
    josh = j_rules.opt_state_shardings(jopt, jpsh, jmesh)
    _assert_same(osh["mu"], josh["mu"], opt["mu"])


def _batches(arch, batch, seq):
    cfg = get_config(arch)
    b = {"tokens": torch.zeros((batch, seq), dtype=torch.int32,
                               device="meta"),
         "labels": torch.zeros((batch, seq), dtype=torch.int32,
                               device="meta")}
    if cfg.mrope_sections is not None:
        b["positions"] = torch.zeros((3, batch, seq), dtype=torch.int32,
                                     device="meta")
    if cfg.encoder is not None:
        b["enc_embed"] = torch.zeros((batch, cfg.encoder.n_ctx, cfg.d_model),
                                     device="meta")
    jb = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.dtype(
        str(v.dtype).replace("torch.", ""))) for k, v in b.items()}
    return b, jb


@pytest.mark.parametrize("batch", [256, 32, 1, 3])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen2-vl-72b",
                                  "whisper-medium"])
def test_batch_specs_equal_reference(arch, mesh, batch):
    """M-RoPE's (3, B, S) positions shard dim 1, an encoder's frames dim
    0; batches that do not divide stay replicated."""
    tmesh, jmesh = _meshes(MESHES[mesh])
    b, jb = _batches(arch, batch, 64)
    for plan in ("baseline", "small"):
        tplan, jplan = _plans(plan, get_config(arch), MESHES[mesh])
        _assert_same(rules.batch_shardings(b, tmesh, tplan),
                     j_rules.batch_shardings(jb, jmesh, jplan), b)


_CACHE_ARCHS = ["internlm2-1.8b", "gemma2-2b", "jamba-v0.1-52b",
                "xlstm-125m", "deepseek-v2-236b", "whisper-medium",
                "llama4-maverick-400b-a17b"]


@pytest.mark.parametrize("shape", [(128, 32768), (1, 524288), (3, 4096)])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", _CACHE_ARCHS)
def test_cache_specs_equal_reference(arch, mesh, shape):
    """KV caches (whisper's ``xk``/``xv`` among them), MLA's ``ckv`` and
    ``krope``, and the recurrent states, at decode_32k's and long_500k's
    shapes and a batch that divides nothing."""
    batch, seq = shape
    cfg, jcfg = get_config(arch), j_get_config(arch)
    with _FAKE:
        cache = tfm.init_cache(cfg, batch, seq)
    jcache = jax.eval_shape(functools.partial(j_tfm.init_cache, jcfg, batch,
                                              seq))
    names = {p[-1] for p, _ in rules.leaves_with_path(cache)
             if isinstance(p[-1], str)}
    if arch == "whisper-medium":
        assert {"xk", "xv"} <= names
    if arch == "deepseek-v2-236b":
        assert {"ckv", "krope"} <= names
    tmesh, jmesh = _meshes(MESHES[mesh])
    for plan in PLANS:
        tplan, jplan = _plans(plan, cfg, MESHES[mesh])
        _assert_same(rules.cache_shardings(cache, cfg, tmesh, tplan),
                     j_rules.cache_shardings(jcache, jcfg, jmesh, jplan),
                     cache)


def test_replicated_equals_reference():
    params, _, jparams, _ = _trees("xlstm-125m")
    tmesh, jmesh = _meshes(False)
    _assert_same(rules.replicated(params, tmesh),
                 j_rules.replicated(jparams, jmesh), params)


@pytest.mark.parametrize("args", [("clients",), ("clients", "data", 2),
                                  ("clients", "data", 1), ("c", "d", 3),
                                  ("clients", None, 2), ("clients", "data")])
def test_cohort_pspec_equals_reference(args):
    assert tuple(rules.cohort_pspec(*args)) == tuple(
        j_rules.cohort_pspec(*args))


def test_cohort_pspec_rejects_dim_zero():
    for mod in (rules, j_rules):
        with pytest.raises(ValueError, match="data_dim"):
            mod.cohort_pspec("clients", "data", 0)


def test_cohort_shardings_equal_reference():
    tmesh = Mesh(np.asarray([torch.device("meta")] * 8,
                            dtype=object).reshape(4, 2), ("clients", "data"))
    jmesh = AbstractMesh((4, 2), ("clients", "data"))
    for kw in ({}, {"data_axis": "data", "data_dim": 2},
               {"data_axis": "data", "data_dim": 1}):
        assert tuple(rules.cohort_batch_sharding(tmesh, **kw).spec) == tuple(
            j_rules.cohort_batch_sharding(jmesh, **kw).spec)
    for dim in (0, 1):
        a = rules.data_shard_sharding(tmesh, "data", dim)
        b = j_rules.data_shard_sharding(jmesh, "data", dim)
        assert tuple(a.spec) == tuple(b.spec)
        assert a.shard_shape((8, 6)) == b.shard_shape((8, 6))
    stacked = {"w": torch.zeros((4, 3, 5), device="meta"),
               "b": [torch.zeros((4, 5), device="meta")]}
    jstacked = {"w": jax.ShapeDtypeStruct((4, 3, 5), np.float32),
                "b": [jax.ShapeDtypeStruct((4, 5), np.float32)]}
    _assert_same(rules.stacked_client_shardings(stacked, tmesh,
                                                data_axis="data"),
                 j_rules.stacked_client_shardings(jstacked, jmesh,
                                                  data_axis="data"),
                 stacked)
    for mod, mesh in ((rules, tmesh), (j_rules, jmesh)):
        with pytest.raises(ValueError, match="nope"):
            mod.stacked_client_shardings(stacked if mod is rules
                                         else jstacked, mesh, axis="nope")
        with pytest.raises(ValueError, match="nope"):
            mod.cohort_batch_sharding(mesh, "clients", "nope", 2)


def test_shard_bytes_is_the_device_block():
    """``shard_bytes`` is the bytes of the block ``shard_shape`` gives."""
    tmesh, _ = _meshes(True)
    leaf = torch.zeros((64, 32, 48), dtype=torch.bfloat16, device="meta")
    sh = rules.NamedSharding(tmesh, rules.P(("pod", "data"), "model", None))
    assert sh.shard_shape(leaf.shape) == (2, 2, 48)
    assert sh.shard_bytes(leaf) == 2 * 2 * 48 * 2
    with pytest.raises(ValueError, match="split"):
        rules.NamedSharding(tmesh, rules.P("data")).shard_shape((24,))


def test_small_model_plan_spreads_batch_over_every_axis():
    plan = rules.small_model_plan(("data",), "model", 10**9)
    jplan = j_rules.small_model_plan(("data",), "model", 10**9)
    assert plan.batch_axes == jplan.batch_axes == ("data", "model")
    assert plan._fsdp_axes == jplan._fsdp_axes
    assert (plan.enable_tp, plan.enable_fsdp) == (jplan.enable_tp,
                                                  jplan.enable_fsdp)
