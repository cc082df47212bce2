"""The port's cohort engine over a device mesh against the reference's
sharded engine.

The port runs on ``[torch.device("cpu")] * 4``: a 1-D ``clients`` mesh of 4
devices and a 2x2 (clients, data) mesh.  The reference runs its
``shard_map`` engine in a subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (jax locks the
device count at its first use), once for the module; its outputs come back
in a pickle.  jax 0.9.0's ``shard_map`` refuses the reference's 1-D
training program under its replication check (the optimizer's step
counter enters the scan typed as replicated and leaves it typed as varying
over ``clients``), so the subprocess passes ``check_rep=False`` to every
``shard_map``, as the reference's 2-D programs already do; the check
changes no arithmetic.  VGG_TINY at 16x16 on MNIST, ragged shards of 40 to 140
samples, K from 2 to 5 clients, weights from the reference's
``PRNGKey`` carried over with ``params_from_numpy``.  Tolerances and their
reasons:

* stacked aggregation: bit for bit -- probed on XLA:CPU: each device sums
  its block (left to right, and each einsum row a chain of fused
  multiply-adds), the all-reduce adds the partials in device order, and
  the mean's ``/ k`` is a true division; the port does the same;
* trained leaves: 5e-3, losses 5e-2 -- the reference's own ``ATOL`` between
  its im2col training and its convolutions (``tests/test_torch_cohort.py``);
* accuracies and signatures of the reference's trained models, evaluated by
  both engines: equal -- exact counts and k/256 fractions, summed over the
  data slices and divided once;
* the port's meshed engine against its own single-device engine: trained
  leaves at the same 5e-3 (the groups' and data slices' sums are other
  float32 orders), evaluation and signatures equal;
* a 2-round coordinator on each mesh: every round, a verified DAG.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.cnn import vgg_for as j_vgg_for  # noqa: E402
from repro.models.cnn import init_cnn as j_init  # noqa: E402
from repro_torch.configs.cnn import vgg_for  # noqa: E402
from repro_torch.core import aggregate as agg  # noqa: E402
from repro_torch.core.coordinator import DagAflConfig, DagAflCoordinator  # noqa: E402
from repro_torch.core.simulator import CostModel  # noqa: E402
from repro_torch.core.tip_selection import TipSelectionConfig  # noqa: E402
from repro_torch.core.verify import verify_full_dag  # noqa: E402
from repro_torch.data.partition import partition_dirichlet  # noqa: E402
from repro_torch.data.synthetic import (Dataset, make_benchmark_dataset,  # noqa: E402
                                        split_811)
from repro_torch.fl.backend import CNNBackend  # noqa: E402
from repro_torch.fl.cohort import CohortBackend  # noqa: E402
from repro_torch.launch.mesh import make_cohort_mesh  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")
ATOL = 5e-3
MESHES = {"1d": (4, 1), "2x2": (2, 2)}
KS = (2, 3, 4, 5)
CPU4 = [torch.device("cpu")] * 4

# The world both processes build: shards, seeds and genesis keys from
# numpy seeds and PRNGKey(i), the same in each.
_WORLD = r'''
import numpy as np
def shards_for(k, Dataset, make_benchmark_dataset, split_811):
    train = split_811(make_benchmark_dataset("mnist", n_samples=700,
                                             seed=2))["train"]
    rng = np.random.default_rng(100 + k)
    sizes = [int(rng.integers(40, 140)) for _ in range(k)]
    out = []
    for s in sizes:
        idx = rng.choice(len(train), size=s, replace=False)
        out.append(Dataset(train.x[idx], train.y[idx]))
    seeds = [int(s) for s in rng.integers(2 ** 31, size=k)]
    return out, seeds

def agg_inputs(m):
    rng = np.random.default_rng(7 + m)
    x = {"a": (rng.standard_normal((m, 5, 7))
               * np.exp(2 * rng.standard_normal((m, 5, 7)))).astype(
                   np.float32),
         "b": [rng.standard_normal((m, 33)).astype(np.float32)]}
    w2 = (rng.random((3, m)) + 0.01).astype(np.float32)
    w2[:, rng.random(m) < 0.3] = 0.0
    w2[:, 0] += 0.5
    return x, w2, (rng.random(m) + 0.01).astype(np.float32)

def coordinator_world(partition_dirichlet, split_811, make_benchmark_dataset):
    splits = split_811(make_benchmark_dataset("mnist", n_samples=700,
                                              seed=2))
    parts = partition_dirichlet(splits["train"], 4, beta=0.5, seed=0)
    cd = []
    for p in parts:
        s = split_811(p, seed=1)
        cd.append({"train": s["train"], "val": s["val"], "test": s["test"]})
    return cd, splits["test"]
'''

_REFERENCE = _WORLD + r'''
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp
import jax.experimental.shard_map as shard_map_mod
_checked = shard_map_mod.shard_map

def _unchecked(*args, **kw):
    kw["check_rep"] = False
    return _checked(*args, **kw)

shard_map_mod.shard_map = _unchecked
from repro.configs.cnn import vgg_for
from repro.core import aggregate as A
from repro.core import (DagAflConfig, DagAflCoordinator, TipSelectionConfig,
                        verify_full_dag)
from repro.core.simulator import CostModel
from repro.data import partition_dirichlet
from repro.data.synthetic import Dataset, make_benchmark_dataset, split_811
from repro.fl.backend import CNNBackend
from repro.fl.cohort import CohortBackend
from repro.launch.mesh import make_cohort_mesh

def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)

out = {}
backend = CNNBackend(vgg_for("mnist"), local_epochs=1, batch_size=32)
for name, (c, d) in {"1d": (4, 1), "2x2": (2, 2)}.items():
    mesh = make_cohort_mesh(c, data=d)
    assert mesh.devices.size == 4, mesh
    for m in (2, 3, 5, 7, 11):
        x, w2, w1 = agg_inputs(m)
        xs = jax.tree_util.tree_map(jnp.asarray, x)
        out[(name, "agg", m)] = (
            np_tree(A.stacked_mean(xs, mesh=mesh, data_axis="data")),
            np_tree(A.stacked_weighted(xs, w2, mesh=mesh, data_axis="data")),
            np_tree(A.stacked_weighted(xs, w1, mesh=mesh, data_axis="data")))
    for k in (2, 3, 4, 5):
        shards, seeds = shards_for(k, Dataset, make_benchmark_dataset,
                                   split_811)
        engine = CohortBackend(backend, capacity=k, mesh=mesh)
        params = [backend.init(jax.random.PRNGKey(i)) for i in range(k)]
        trained, losses = engine.train_cohort(params, shards, seeds)
        out[(name, "train", k)] = ([np_tree(p) for p in trained], losses)
        out[(name, "eval", k)] = (
            engine.evaluate_cohort(trained, shards),
            engine.evaluate_shared(trained[0], shards),
            engine.evaluate_many(trained, shards[0]),
            np.asarray(engine.signature_cohort(trained, shards)))
    cd, test = coordinator_world(partition_dirichlet, split_811,
                                 make_benchmark_dataset)
    cfg = DagAflConfig(n_clients=4, max_rounds=2, local_epochs=1,
                       tip=TipSelectionConfig(n_select=2), seed=0,
                       cohort_size=4, cohort_window=2.0, mesh=mesh)
    coord = DagAflCoordinator(backend, cd, test, cfg,
                              CostModel(local_epoch=2.0))
    assert coord.cohort.mesh is not None
    res = coord.run(jax.random.PRNGKey(0))
    out[(name, "coord")] = (res.rounds, res.extra["chain_len"],
                            res.extra["verify_failures"],
                            res.extra["cohorts_dispatched"],
                            float(res.final_accuracy),
                            verify_full_dag(coord.ledger)[0])
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
'''

_ns = {}
exec(_WORLD, _ns)
shards_for, agg_inputs, coordinator_world = (
    _ns["shards_for"], _ns["agg_inputs"], _ns["coordinator_world"])


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's sharded engine on 4 forced host devices."""
    path = tmp_path_factory.mktemp("mesh") / "ref.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", _REFERENCE, str(path)],
                         capture_output=True, text=True, cwd=REPO, env=env,
                         timeout=900)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def backend():
    return CNNBackend(vgg_for("mnist"), local_epochs=1, batch_size=32,
                      device="cpu")


def _mesh(name):
    c, d = MESHES[name]
    return make_cohort_mesh(c, data=d, devices=CPU4)


def _genesis(k):
    return [params_from_numpy(jax.tree_util.tree_map(
        np.asarray, j_init(jax.random.PRNGKey(i), j_vgg_for("mnist"))),
        "cpu") for i in range(k)]


def _np(tree):
    return [np.asarray(a) for a in agg.tree_leaves(tree)]


def _jleaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _torch_tree(tree):
    return agg.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("m", [2, 3, 5, 7, 11])
@pytest.mark.parametrize("mesh", MESHES)
def test_stacked_aggregation_equals_reference_bits(ref, mesh, m):
    x, w2, w1 = agg_inputs(m)
    want = ref[(mesh, "agg", m)]
    tm = _mesh(mesh)
    got = (agg.stacked_mean(_torch_tree(x), mesh=tm, data_axis="data"),
           agg.stacked_weighted(_torch_tree(x), w2, mesh=tm,
                                data_axis="data"),
           agg.stacked_weighted(_torch_tree(x), w1, mesh=tm,
                                data_axis="data"))
    for g, w in zip(got, want):
        for a, b in zip(_np(g), _jleaves(w)):
            assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("mesh", MESHES)
def test_training_matches_reference(ref, backend, mesh, k):
    """Ragged K on the mesh: each client's trained leaves and loss."""
    shards, seeds = shards_for(k, Dataset, make_benchmark_dataset, split_811)
    engine = CohortBackend(backend, mesh=_mesh(mesh))
    assert engine.mesh is not None and engine._n_data == MESHES[mesh][1]
    trained, losses = engine.train_cohort(_genesis(k), shards, seeds)
    want, want_losses = ref[(mesh, "train", k)]
    assert len(trained) == len(losses) == k
    for i in range(k):
        for a, b in zip(_np(trained[i]), _jleaves(want[i])):
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL,
                                       err_msg=f"client {i}")
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=5e-2)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("mesh", MESHES)
def test_evaluation_and_signatures_equal_reference(ref, backend, mesh, k):
    """The reference's trained models through the port's meshed
    ``evaluate_cohort``, ``evaluate_shared``, ``evaluate_many`` and
    ``signature_cohort``: the same accuracies and signatures."""
    shards, _ = shards_for(k, Dataset, make_benchmark_dataset, split_811)
    models = [params_from_numpy(p, "cpu") for p in ref[(mesh, "train", k)][0]]
    engine = CohortBackend(backend, mesh=_mesh(mesh))
    accs, shared, many, sigs = ref[(mesh, "eval", k)]
    assert engine.evaluate_cohort(models, shards) == accs
    assert engine.evaluate_shared(models[0], shards) == shared
    assert engine.evaluate_many(models, shards[0]) == many
    assert np.array_equal(engine.signature_cohort(models, shards), sigs)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("mesh", MESHES)
def test_meshed_engine_matches_single_device(backend, mesh, k):
    """The port's meshed engine against its own single-device engine."""
    shards, seeds = shards_for(k, Dataset, make_benchmark_dataset, split_811)
    single = CohortBackend(backend)
    meshed = CohortBackend(backend, mesh=_mesh(mesh))
    p1, l1 = single.train_cohort(_genesis(k), shards, seeds)
    p2, l2 = meshed.train_cohort(_genesis(k), shards, seeds)
    for i in range(k):
        for a, b in zip(_np(p1[i]), _np(p2[i])):
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    np.testing.assert_allclose(l1, l2, rtol=0, atol=5e-2)
    assert single.evaluate_cohort(p1, shards) == meshed.evaluate_cohort(
        p1, shards)
    assert single.evaluate_shared(p1[0], shards) == meshed.evaluate_shared(
        p1[0], shards)
    assert single.evaluate_many(p1, shards[0]) == meshed.evaluate_many(
        p1, shards[0])
    assert np.array_equal(single.signature_cohort(p1, shards),
                          meshed.signature_cohort(p1, shards))
    assert all(p.device.type == "cpu" for m in p2
               for p in agg.tree_leaves(m))


@pytest.mark.parametrize("mesh", MESHES)
def test_coordinator_runs_two_rounds_on_the_mesh(ref, backend, mesh):
    """DAG-AFL over the mesh: every round runs, the chain holds 1 + rounds
    transactions, the DAG verifies, and the run agrees with the
    reference's on the same mesh."""
    cd, test = coordinator_world(partition_dirichlet, split_811,
                                 make_benchmark_dataset)
    cfg = DagAflConfig(n_clients=4, max_rounds=2, local_epochs=1,
                       tip=TipSelectionConfig(n_select=2), seed=0,
                       cohort_size=4, cohort_window=2.0, mesh=_mesh(mesh))
    coord = DagAflCoordinator(backend, cd, test, cfg,
                              CostModel(local_epoch=2.0))
    assert coord.cohort.mesh is not None
    res = coord.run(_genesis(1)[0])
    rounds, chain, failures, windows, acc, ok = ref[(mesh, "coord")]
    assert res.rounds == rounds == 8
    assert res.extra["chain_len"] == chain == 1 + res.rounds
    assert res.extra["verify_failures"] == failures == 0
    assert res.extra["cohorts_dispatched"] == windows >= 1
    assert verify_full_dag(coord.ledger) == (True, "ok") and ok
    assert abs(res.final_accuracy - acc) <= 0.05
