"""The port's baselines (``repro_torch.fl.baselines``) against the JAX
reference's (``repro.fl.baselines``).

(A) A deterministic numpy stub backend drives both packages.  Its
arithmetic is numpy float32, and the aggregations (Eq. 6 means, weighted
means, FedAsync's interpolation with its fused multiply-add) are
bit-identical in the two packages, so every algorithm's ``RunResult`` must
be equal field for field: rounds, simulated time, history, accuracies and
``extra`` (fedat's tiers and tier updates, the DAG runs' counters), honest
and under the poison, lazy, straggler and dropout scenarios and stale
free-riders (``lazy_mode="stale"``).

(B) VGG_TINY backends from the same JAX genesis (``params_from_numpy``).
With convergence by patience switched off the schedules are pure host RNG,
so rounds, simulated time and the history's times must be equal; training
differs in the last float32 bits between the frameworks, so accuracies
agree within 0.05 (a few validation samples of these shards).  All ten
algorithms sequentially, and the six the reference batches at
``cohort_size=3``, with equal ``cohorts_dispatched``.

(C) One reduced-internlm2 ``LMBackend`` world runs fedavg and dagafl in
both packages: the harness takes any backend.
"""
import dataclasses
from dataclasses import dataclass

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.fl as J  # noqa: E402
import repro_torch.fl as T  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.configs.cnn import vgg_for as j_vgg_for  # noqa: E402
from repro.core.simulator import CostModel as JCost  # noqa: E402
from repro.core.simulator import make_profiles  # noqa: E402
from repro.data import make_benchmark_dataset, make_lm_dataset  # noqa: E402
from repro.data import partition_dirichlet, split_811  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro.models.cnn import init_cnn as j_init_cnn  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.cnn import vgg_for  # noqa: E402
from repro_torch.core.aggregate import tree_leaves  # noqa: E402
from repro_torch.core.simulator import CostModel as TCost  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two torch threads while this module runs: its many small CPU
    convolutions beside JAX's threads and the other test workers'
    oversubscribe the cores (about 2x faster under the suite's 6 workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ALGOS = sorted(J.ALGORITHMS)
COHORT_ALGOS = ["fedavg", "fedasync", "fedat", "csafl", "dagfl", "dagafl"]
RESULT_FIELDS = ("name", "final_accuracy", "best_accuracy", "sim_time",
                 "rounds", "history", "extra")


# -- (A) the stub backend -----------------------------------------------------


@dataclass
class StubData:
    """A client shard for the stub: a target the training pulls toward, a
    signature scale, and labels (csafl groups by them, poisoning flips
    them)."""
    target: np.ndarray
    scale: np.float32
    y: np.ndarray

    def __len__(self):
        return len(self.y)


class StubBackend:
    """A deterministic numpy stand-in for a training backend: a model is a
    small tree; training pulls it toward the client's target with seeded
    noise; accuracy and signature are functions of the weights."""

    def __init__(self, native):
        self.native = native          # numpy -> the package's array type

    def _tree(self, w, b):
        return {"w": self.native(w), "extra": [{"b": self.native(b)}]}

    def init(self, _rng):
        return self._tree(np.linspace(-1, 1, 8, dtype=np.float32),
                          np.zeros(3, np.float32))

    def train_local(self, params, ds, seed=0, epochs=None):
        rng = np.random.default_rng(seed)
        w = np.asarray(params["w"], np.float32)
        b = np.asarray(params["extra"][0]["b"], np.float32)
        noise = rng.normal(0.0, 0.05, w.shape).astype(np.float32)
        w = w + np.float32(0.5) * (ds.target - w) + noise
        return self._tree(w, b + np.float32(0.25)), 0.0

    def evaluate(self, params, ds, limit=512):
        w = np.asarray(params["w"], np.float32)
        return float(np.float32(1) / (np.float32(1)
                                      + np.mean(np.abs(w - ds.target))))

    def signature(self, params, ds, limit=128):
        w = np.asarray(params["w"], np.float32)
        return np.abs(np.tanh(w * ds.scale)).astype(np.float32)


def stub_world(n_clients=4):
    rng = np.random.default_rng(42)
    data = []
    for c in range(n_clients):
        part = StubData(rng.normal(0, 1, 8).astype(np.float32),
                        np.float32(rng.uniform(0.5, 2.0)),
                        rng.integers(0, 10, 20 + 7 * c))
        data.append({"train": part, "val": part, "test": part})
    test = StubData(np.zeros(8, np.float32), np.float32(1.0), np.arange(10))
    pooled = StubData(np.mean([d["train"].target for d in data], axis=0)
                      .astype(np.float32), np.float32(1.0),
                      np.arange(50) % 10)
    return data, test, pooled


def run_both(name, data, test, fl_kw, pooled=None, j_backend=None,
             t_backend=None, j_cost=None, t_cost=None, profiles=None,
             init_model=None):
    """One run of algorithm ``name`` in each package, same world."""
    kw = {"pooled_train": pooled} if name == "centralized" else {}
    ref = J.ALGORITHMS[name](
        j_backend or StubBackend(jnp.asarray), data, test,
        J.FLConfig(**fl_kw), j_cost or JCost(), profiles, **kw)
    got = T.ALGORITHMS[name](
        t_backend or StubBackend(torch.from_numpy), data, test,
        T.FLConfig(**fl_kw), t_cost or TCost(), profiles,
        init_model=init_model, **kw)
    return ref, got


@pytest.mark.parametrize("scenario", [None, "poison", "lazy", "straggler",
                                      "dropout", "stale"])
@pytest.mark.parametrize("name", ALGOS)
def test_stub_results_identical(name, scenario):
    """``stale``: half the clients free-ride by resubmitting their own
    previous model (``lazy_mode="stale"``, no registry entry)."""
    if scenario == "stale":
        scenario = T.ScenarioConfig(name="stale", lazy_frac=0.5,
                                    lazy_mode="stale")
    data, test, pooled = stub_world()
    ref, got = run_both(name, data, test,
                        dict(n_clients=4, max_rounds=3, local_epochs=1,
                             patience=10 ** 6, scenario=scenario),
                        pooled=pooled)
    for field in RESULT_FIELDS:
        assert getattr(got, field) == getattr(ref, field), field
    assert got.rounds >= 3 and got.history
    if name == "fedat":
        assert got.extra["tiers"] == ref.extra["tiers"]
        assert got.extra["tier_updates"] == ref.extra["tier_updates"]
        assert sum(got.extra["tier_updates"]) == 3 + got.rounds


def test_stub_convergence_by_patience_stops_alike():
    """With the tracker on, the stopping round is the reference's too."""
    data, test, pooled = stub_world()
    for name in ("fedavg", "fedasync", "dagafl"):
        ref, got = run_both(name, data, test,
                            dict(n_clients=4, max_rounds=8, local_epochs=1,
                                 target_accuracy=0.5, patience=2))
        for field in RESULT_FIELDS:
            assert getattr(got, field) == getattr(ref, field), (name, field)


def test_fedat_tier_weights_pinned_values():
    assert T.fedat_tier_weights([2, 5, 4], [0, 1, 2]) == \
        J.fedat_tier_weights([2, 5, 4], [0, 1, 2]) == [0.5, 0.2, 0.25]
    assert T.fedat_tier_weights([2, 5, 4], [2, 0]) == [0.25, 0.5]


def test_flconfig_carries_the_ported_knobs_only():
    ref = {f.name: f.default for f in dataclasses.fields(J.FLConfig)}
    got = {f.name: f.default for f in dataclasses.fields(T.FLConfig)}
    assert set(ref) - set(got) == {"kernel_policy"}
    assert set(got) <= set(ref)
    assert all(got[k] == ref[k] for k in got)


@pytest.mark.parametrize("mesh", ["2x2", ("auto", 2), "8"])
def test_harness_takes_one_card_only(mesh):
    """A mesh spec builds the harness: the stub backend has no cohort
    suite, so the run is sequential and equals the run without a mesh, as
    in the reference."""
    data, test, _ = stub_world()
    runs = [T.run_fedavg(StubBackend(torch.from_numpy), data, test,
                         T.FLConfig(n_clients=4, max_rounds=1, mesh=m,
                                    cohort_size=2))
            for m in (mesh, None)]
    assert runs[0].history == runs[1].history
    assert runs[0].final_accuracy == runs[1].final_accuracy


def test_genesis_defaults_to_the_seeded_generator():
    """``init_model=None`` draws ``backend.init(Generator(cfg.seed))``."""
    cfg = vgg_for("mnist")
    backend = T.CNNBackend(cfg, local_epochs=1, batch_size=32, device="cpu")
    data, test = _cnn_world()
    fl = T.FLConfig(n_clients=3, max_rounds=1, local_epochs=1, seed=5,
                    patience=10 ** 6)
    drawn = T.run_fedavg(backend, data, test, fl)
    given = T.run_fedavg(backend, data, test, fl, init_model=backend.init(
        torch.Generator().manual_seed(5)))
    assert drawn.final_accuracy == given.final_accuracy
    assert drawn.history == given.history


# -- (B) VGG_TINY from the JAX genesis ----------------------------------------


def _cnn_world():
    ds = make_benchmark_dataset("mnist", n_samples=900, seed=0)
    splits = split_811(ds)
    parts = partition_dirichlet(splits["train"], 3, beta=0.5, seed=0)
    data = []
    for p in parts:
        s = split_811(p, seed=1)
        data.append({"train": s["train"], "val": s["val"], "test": s["test"]})
    return data, splits["test"]


@pytest.fixture(scope="module")
def vgg_world():
    ds = make_benchmark_dataset("mnist", n_samples=900, seed=0)
    splits = split_811(ds)
    data, test = _cnn_world()
    genesis = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, j_init_cnn(jax.random.PRNGKey(0), j_vgg_for("mnist"))),
        "cpu")
    return {"data": data, "test": test, "pooled": splits["train"],
            "genesis": genesis,
            "j_backend": J.CNNBackend(j_vgg_for("mnist"), local_epochs=1,
                                      batch_size=32),
            "t_backend": T.CNNBackend(vgg_for("mnist"), local_epochs=1,
                                      batch_size=32, device="cpu")}


def _vgg_pair(world, name, **fl_kw):
    return run_both(
        name, world["data"], world["test"],
        dict(n_clients=3, max_rounds=2, local_epochs=1, seed=0,
             patience=10 ** 6, **fl_kw),
        pooled=world["pooled"], j_backend=world["j_backend"],
        t_backend=world["t_backend"], j_cost=JCost(local_epoch=2.0),
        t_cost=TCost(local_epoch=2.0), profiles=make_profiles(3, 0.5, 0),
        init_model=world["genesis"])


def _assert_schedule_and_accuracy(ref, got):
    assert got.name == ref.name
    assert got.rounds == ref.rounds >= 2
    assert got.sim_time == ref.sim_time
    assert [t for t, _ in got.history] == [t for t, _ in ref.history]
    assert abs(got.final_accuracy - ref.final_accuracy) <= 0.05
    assert abs(got.best_accuracy - ref.best_accuracy) <= 0.05
    for (_, a), (_, b) in zip(got.history, ref.history):
        assert abs(a - b) <= 0.05
    assert 0.0 <= got.final_accuracy <= 1.0


@pytest.mark.parametrize("name", ALGOS)
def test_vgg_tiny_sequential_matches_reference(name, vgg_world):
    ref, got = _vgg_pair(vgg_world, name)
    _assert_schedule_and_accuracy(ref, got)
    if name == "fedat":
        assert got.extra == ref.extra
    if name in ("dagfl", "dagafl"):
        for key in ("chain_len", "verify_failures", "cohorts_dispatched"):
            assert got.extra[key] == ref.extra[key], key
        assert got.extra["cohorts_dispatched"] == 0


@pytest.mark.parametrize("name", COHORT_ALGOS)
def test_vgg_tiny_cohort_matches_reference(name, vgg_world):
    ref, got = _vgg_pair(vgg_world, name, cohort_size=3, cohort_window=2.0)
    _assert_schedule_and_accuracy(ref, got)
    if name in ("dagfl", "dagafl"):
        assert got.extra["cohorts_dispatched"] == \
            ref.extra["cohorts_dispatched"] >= 1
        assert got.extra["chain_len"] == ref.extra["chain_len"] == 7


def test_vgg_tiny_cohort_engine_trains_the_fedavg_round(vgg_world,
                                                        monkeypatch):
    """fedavg's three clients train as one window on the engine."""
    from repro_torch.fl.cohort import CohortBackend
    calls = []
    inner = CohortBackend.train_cohort

    def counted(self, params_list, *args, **kwargs):
        calls.append(len(params_list))
        return inner(self, params_list, *args, **kwargs)

    monkeypatch.setattr(CohortBackend, "train_cohort", counted)
    res = T.run_fedavg(vgg_world["t_backend"], vgg_world["data"],
                       vgg_world["test"],
                       T.FLConfig(n_clients=3, max_rounds=2, local_epochs=1,
                                  patience=10 ** 6, cohort_size=3),
                       TCost(local_epoch=2.0), make_profiles(3, 0.5, 0),
                       init_model=vgg_world["genesis"])
    assert calls == [3, 3] and res.rounds == 2


# -- (C) the LM backend --------------------------------------------------------


def test_lm_backend_fedavg_and_dagafl_match_reference():
    from repro.fl.backend import LMBackend as JLM
    kw = dict(lr=5e-3, local_steps=2, batch_size=8, seq_len=64)
    jc = dataclasses.replace(j_reduced(j_get_config("internlm2-1.8b"),
                                       d_model=64), vocab_size=128)
    tc = dataclasses.replace(reduced(get_config("internlm2-1.8b"),
                                     d_model=64), vocab_size=128)
    jb = JLM(jc, kernel_policy="interpret", **kw)
    tb = T.LMBackend(tc, device="cpu", **kw)
    streams = [make_lm_dataset(vocab=128, n_tokens=6000, order=2.0, seed=c)
               for c in range(3)]
    data = [{"train": s, "val": s, "test": s} for s in streams]
    test = make_lm_dataset(vocab=128, n_tokens=6000, order=2.0, seed=10_000)
    genesis = params_from_numpy(jax.tree_util.tree_map(
        np.array, j_tfm.init_params(jax.random.PRNGKey(0), jc)), "cpu")
    # token streams have no labels: poisoning leaves them as they are
    sc = T.Scenario(T.SCENARIOS["poison"], 3)
    assert sc.poison_data(data) is data and sc.clients_poisoned == 0
    for name in ("fedavg", "dagafl"):
        ref, got = run_both(name, data, test,
                            dict(n_clients=3, max_rounds=2, local_epochs=2,
                                 seed=0, patience=10 ** 6),
                            j_backend=jb, t_backend=tb,
                            init_model=genesis)
        assert got.rounds == ref.rounds
        assert got.sim_time == ref.sim_time
        assert [t for t, _ in got.history] == [t for t, _ in ref.history]
        assert abs(got.final_accuracy - ref.final_accuracy) <= 0.05
        assert all(p.device.type == "cpu" for p in tree_leaves(genesis))
