"""The port's fault scenarios (``repro_torch.fl.scenarios``, the update
transform in ``repro_torch.fl.cohort`` and the coordinator's hooks)
against the JAX reference.

* The scenario API is numpy in both packages: roles, update plans,
  duration multipliers, dropout draws, poisoned labels and counts are
  equal, exactly.
* The transform ``agg + gamma*(new - agg) + sigma*N(0, I)``: without noise
  it is held to JAX's ``perturb_update`` within 1e-6 (its products are
  fused into the sums as XLA fuses them, so the bits agree too; the test
  reports how many differ); a stacked window equals K single calls bit for
  bit, unaffected rows and integer leaves keep their bits, and the DP
  noise (``torch.Generator``, not ``jax.random``) has the reference's mean
  and standard deviation within 1%.
* End to end: a zero-rate scenario is bit-identical to ``scenario=None``
  in the port; ``scenario_counts`` equal the reference's under poison,
  lazy, straggler and dropout, sequentially and at ``cohort_size=3``; on
  the stub backend ``dag_attack_metrics`` and the tamper detections are
  the reference's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.fl as J  # noqa: E402
import repro_torch.fl as T  # noqa: E402
from repro.configs.cnn import vgg_for as j_vgg_for  # noqa: E402
from repro.core import aggregate as j_agg  # noqa: E402
from repro.core.coordinator import DagAflConfig as JConfig  # noqa: E402
from repro.core.coordinator import DagAflCoordinator as JCoord  # noqa: E402
from repro.core.simulator import CostModel as JCost  # noqa: E402
from repro.core.simulator import make_profiles  # noqa: E402
from repro.core.verify import IncrementalVerifier as JVerifier  # noqa: E402
from repro.core.verify import detect_tampered as j_detect  # noqa: E402
from repro.data import make_benchmark_dataset  # noqa: E402
from repro.fl.cohort import perturb_cohort_stacked_trees as j_stacked  # noqa: E402
from repro.fl.cohort import perturb_update as j_perturb  # noqa: E402
from repro.models.cnn import init_cnn as j_init_cnn  # noqa: E402
from repro_torch.configs.cnn import vgg_for  # noqa: E402
from repro_torch.core import aggregate as t_agg  # noqa: E402
from repro_torch.core.coordinator import DagAflConfig, DagAflCoordinator  # noqa: E402
from repro_torch.core.simulator import CostModel as TCost  # noqa: E402
from repro_torch.core.verify import IncrementalVerifier, detect_tampered  # noqa: E402
from repro_torch.fl.cohort import perturb_cohort_stacked_trees  # noqa: E402
from repro_torch.fl.cohort import perturb_update  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402
from test_torch_baselines import StubBackend, _cnn_world, stub_world  # noqa: E402
# its autouse fixture, imported so that it applies to this module too
from test_torch_baselines import few_torch_threads  # noqa: E402,F401

MIXED = dict(malicious_frac=0.25, attack="label_flip+scale",
             scale_gamma=-3.0, tamper_rate=0.5, lazy_frac=0.25,
             dp_sigma=0.01, straggler_frac=0.5, dropout_rate=0.3)


def _pair(cfg, n):
    return (J.Scenario(J.ScenarioConfig(**cfg), n),
            T.Scenario(T.ScenarioConfig(**cfg), n))


# -- the numpy scenario API ----------------------------------------------------


def test_registry_matches_reference():
    assert {k: dataclasses.asdict(v) for k, v in T.SCENARIOS.items()} == \
        {k: dataclasses.asdict(v) for k, v in J.SCENARIOS.items()}
    assert dataclasses.asdict(T.ScenarioConfig()) == \
        dataclasses.asdict(J.ScenarioConfig())
    assert T.as_scenario(None, 4) is None
    sc = T.as_scenario("poison", 8)
    assert T.as_scenario(sc, 8) is sc and sc.cfg == T.SCENARIOS["poison"]


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("n", [4, 8, 13])
def test_roles_and_update_plans_match_reference(seed, n):
    ref, got = _pair(dict(MIXED, name="mix", seed=seed), n)
    assert (got.malicious, got.lazy, got.stragglers) == \
        (ref.malicious, ref.lazy, ref.stragglers)
    rng = np.random.default_rng(seed)
    for _ in range(6):
        clients = sorted(rng.choice(n, size=rng.integers(1, n + 1),
                                    replace=False).tolist())
        p_ref, p_got = ref.update_plan(clients), got.update_plan(clients)
        assert p_ref.keys() == p_got.keys()
        for key in p_ref:
            assert np.array_equal(np.asarray(p_got[key]),
                                  np.asarray(p_ref[key])), key
            assert np.asarray(p_got[key]).dtype == \
                np.asarray(p_ref[key]).dtype, key
        for c in clients:
            assert got.wants_stale(c) == ref.wants_stale(c)
    assert got.counts() == ref.counts()


def test_update_plan_none_when_nobody_is_affected():
    ref, got = _pair(dict(name="s", straggler_frac=0.5, dropout_rate=0.5), 4)
    assert got.update_plan([0, 1, 2, 3]) is None
    assert ref.update_plan([0, 1, 2, 3]) is None


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_durations_and_dropouts_match_reference(seed):
    ref, got = _pair(dict(MIXED, name="s", seed=seed), 6)
    for c in [0, 1, 2, 3, 4, 5] * 5:
        assert got.duration_multiplier(c) == ref.duration_multiplier(c)
        assert got.drops_publish(c) == ref.drops_publish(c)
    assert got.counts() == ref.counts()
    assert got.counts()["publishes_dropped"] > 0
    assert got.counts()["straggler_draws"] == 15


@pytest.mark.parametrize("attack,flips", [("label_flip", True),
                                          ("label_flip+scale", True),
                                          ("scale", False)])
def test_poison_data_matches_reference(attack, flips):
    cfg = dict(name="p", seed=2, malicious_frac=0.5, attack=attack)
    ref, got = _pair(cfg, 4)
    data = []
    for c in range(4):
        ds = make_benchmark_dataset("mnist", n_samples=40, seed=c)
        data.append({"train": ds, "val": ds, "test": ds})
    out_ref, out_got = ref.poison_data(data), got.poison_data(data)
    for c in range(4):
        for split in ("train", "val"):
            assert np.array_equal(out_got[c][split].y, out_ref[c][split].y)
            assert out_got[c][split].y.dtype == out_ref[c][split].y.dtype
        assert (out_got[c] is data[c]) == (out_ref[c] is data[c])
        assert (out_got[c] is not data[c]) == (flips and c in got.malicious)
    assert got.counts() == ref.counts()


# -- the update transform --------------------------------------------------------


def _np_trees(k, seed=0):
    rng = np.random.default_rng(seed)

    def tree():
        return {"w": rng.normal(size=(64, 33)).astype(np.float32),
                "b": [rng.normal(size=(33,)).astype(np.float32)],
                "steps": rng.integers(0, 9, size=(5,)).astype(np.int32)}

    return [tree() for _ in range(k)], [tree() for _ in range(k)]


def _as(tree, native):
    return {"w": native(tree["w"]), "b": [native(tree["b"][0])],
            "steps": native(tree["steps"])}


def _plan(gammas, sigmas, affected, clients=None, seqs=None, seed=7):
    k = len(gammas)
    return {"seed": seed,
            "clients": np.asarray(clients if clients is not None
                                  else range(k), np.int64),
            "seqs": np.asarray(seqs if seqs is not None else [0] * k,
                               np.int64),
            "gammas": np.asarray(gammas, np.float32),
            "sigmas": np.asarray(sigmas, np.float32),
            "affected": np.asarray(affected, bool)}


@pytest.mark.parametrize("gamma", [-4.0, 0.0, 0.37, 1.0])
def test_gamma_transform_matches_jax(gamma):
    news, aggs = _np_trees(1, seed=int(gamma * 10) + 50)
    plan = _plan([gamma], [0.0], [True], clients=[3], seqs=[2])
    ref = j_perturb(_as(aggs[0], jnp.asarray), _as(news[0], jnp.asarray),
                    plan, 0)
    got = perturb_update(_as(aggs[0], torch.from_numpy),
                         _as(news[0], torch.from_numpy), plan, 0)
    differing = 0
    for a, b in zip(jax.tree_util.tree_leaves(ref), t_agg.tree_leaves(got)):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
        differing += int(np.sum(a != b))
    print(f"gamma {gamma}: {differing} elements differ from JAX in bits")
    assert np.array_equal(got["steps"].numpy(), news[0]["steps"])


def test_stacked_window_equals_single_calls_bit_for_bit():
    news, aggs = _np_trees(4, seed=1)
    plan = _plan([-4.0, 0.0, 1.0, 0.5], [0.0, 0.02, 0.05, 0.0],
                 [True, True, True, False], clients=[2, 0, 5, 1],
                 seqs=[0, 3, 1, 4])
    stacked = perturb_cohort_stacked_trees(
        t_agg.tree_stack([_as(a, torch.from_numpy) for a in aggs]),
        t_agg.tree_stack([_as(n, torch.from_numpy) for n in news]), plan)
    rows = t_agg.tree_unstack(stacked)
    for k in range(3):
        single = perturb_update(_as(aggs[k], torch.from_numpy),
                                _as(news[k], torch.from_numpy), plan, k)
        for a, b in zip(t_agg.tree_leaves(single), t_agg.tree_leaves(rows[k])):
            assert torch.equal(a, b)
    # the unaffected row keeps its exact bits, integer leaves pass through
    for a, b in zip(t_agg.tree_leaves(_as(news[3], torch.from_numpy)),
                    t_agg.tree_leaves(rows[3])):
        assert torch.equal(a, b)
    for k in range(4):
        assert np.array_equal(rows[k]["steps"].numpy(), news[k]["steps"])
    # the noiseless rows are JAX's window rows (to 1e-6)
    ref = j_agg.tree_unstack(j_stacked(
        j_agg.tree_stack([_as(a, jnp.asarray) for a in aggs]),
        j_agg.tree_stack([_as(n, jnp.asarray) for n in news]), plan))
    for k in (0, 3):
        for a, b in zip(jax.tree_util.tree_leaves(ref[k]),
                        t_agg.tree_leaves(rows[k])):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-6)


def test_unaffected_rows_keep_bits_where_the_transform_is_no_identity():
    news, aggs = _np_trees(3, seed=2)
    plan = _plan([-4.0, 1.0, 1.0], [0.0, 0.0, 0.0], [True, False, False])
    rows = t_agg.tree_unstack(perturb_cohort_stacked_trees(
        t_agg.tree_stack([_as(a, torch.from_numpy) for a in aggs]),
        t_agg.tree_stack([_as(n, torch.from_numpy) for n in news]), plan))
    for k in (1, 2):
        new = _as(news[k], torch.from_numpy)
        for a, b in zip(t_agg.tree_leaves(new), t_agg.tree_leaves(rows[k])):
            assert torch.equal(a, b)
        # gamma = 1 is no identity in float32: what the select protects
        agg = _as(aggs[k], torch.from_numpy)
        redo = t_agg.fma_f32(1.0, new["w"] - agg["w"], agg["w"])
        assert not torch.equal(redo, new["w"])


def test_noise_streams_are_per_client_and_sequence():
    z = {"w": np.zeros((256,), np.float32)}
    zt = {"w": torch.from_numpy(z["w"])}

    def noise(client, seq, seed=7):
        plan = _plan([1.0], [0.1], [True], clients=[client], seqs=[seq],
                     seed=seed)
        return perturb_update(zt, zt, plan, 0)["w"]

    assert torch.equal(noise(1, 0), noise(1, 0))
    for other in (noise(2, 0), noise(1, 1), noise(1, 0, seed=8)):
        assert not torch.equal(noise(1, 0), other)
    # a row's noise does not depend on its place in the window
    plan = _plan([1.0, 1.0], [0.1, 0.1], [True, True], clients=[4, 1],
                 seqs=[0, 0])
    rows = perturb_cohort_stacked_trees(
        t_agg.tree_stack([zt, zt]), t_agg.tree_stack([zt, zt]), plan)
    assert torch.equal(rows["w"][1], noise(1, 0))


def test_dp_noise_moments_match_the_reference_in_distribution():
    sigma = 0.05
    n = 1 << 20
    z = np.zeros((n,), np.float32)
    plan = _plan([1.0], [sigma], [True], clients=[1], seqs=[0])
    got = perturb_update({"w": torch.from_numpy(z)},
                         {"w": torch.from_numpy(z)}, plan, 0)["w"].double()
    ref = np.asarray(j_perturb({"w": jnp.asarray(z)}, {"w": jnp.asarray(z)},
                               plan, 0)["w"], np.float64)
    for draws in (got.numpy(), ref):
        assert abs(draws.mean()) <= 0.01 * sigma
        assert abs(draws.std() - sigma) <= 0.01 * sigma
    assert abs(got.std().item() - ref.std()) <= 0.01 * sigma
    assert not np.array_equal(got.numpy(), ref)     # other generator


# -- end to end ------------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    data, test = _cnn_world()
    genesis = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, j_init_cnn(jax.random.PRNGKey(0), j_vgg_for("mnist"))),
        "cpu")
    return {"data": data, "test": test, "genesis": genesis,
            "j_backend": J.CNNBackend(j_vgg_for("mnist"), local_epochs=1,
                                      batch_size=32),
            "t_backend": T.CNNBackend(vgg_for("mnist"), local_epochs=1,
                                      batch_size=32, device="cpu")}


def _dag_kw(cohort_size, max_rounds=2):
    return dict(n_clients=3, max_rounds=max_rounds, local_epochs=1, seed=0,
                target_accuracy=None, patience=10 ** 6,
                cohort_size=cohort_size, cohort_window=2.0)


def _port_dag(world, scenario, cohort_size):
    coord = DagAflCoordinator(world["t_backend"], world["data"],
                              world["test"],
                              DagAflConfig(scenario=scenario,
                                           **_dag_kw(cohort_size)),
                              TCost(local_epoch=2.0),
                              make_profiles(3, 0.5, 0))
    return coord, coord.run(world["genesis"])


def _hashes(coord):
    return [t.tx_hash for t in sorted(coord.ledger.transactions(),
                                      key=lambda t: t.seq)]


@pytest.mark.parametrize("cohort_size", [1, 3])
def test_zero_rate_scenario_is_bit_identical_on_the_coordinator(
        world, cohort_size):
    zero = T.ScenarioConfig(name="zero")
    c_none, r_none = _port_dag(world, None, cohort_size)
    c_zero, r_zero = _port_dag(world, zero, cohort_size)
    assert _hashes(c_zero) == _hashes(c_none)
    for field in ("final_accuracy", "best_accuracy", "sim_time", "rounds",
                  "history"):
        assert getattr(r_zero, field) == getattr(r_none, field), field
    assert r_zero.extra.pop("scenario") == "zero"
    assert not any(r_zero.extra.pop("scenario_counts").values())
    assert r_zero.extra == r_none.extra
    for tx in c_zero.ledger.transactions():
        a = c_zero.store.get(tx.model_ref)
        b = c_none.store.get(c_none.ledger.get_tx(tx.tx_id).model_ref)
        assert all(torch.equal(x, y) for x, y in
                   zip(t_agg.tree_leaves(a), t_agg.tree_leaves(b)))


@pytest.mark.parametrize("name", ["fedavg", "fedasync"])
def test_zero_rate_scenario_is_bit_identical_on_the_baselines(world, name):
    kw = dict(n_clients=3, max_rounds=2, local_epochs=1, seed=0,
              patience=10 ** 6)
    runs = [T.ALGORITHMS[name](world["t_backend"], world["data"],
                               world["test"], T.FLConfig(scenario=sc, **kw),
                               TCost(local_epoch=2.0),
                               make_profiles(3, 0.5, 0),
                               init_model=world["genesis"])
            for sc in (None, T.ScenarioConfig(name="zero"))]
    for field in ("final_accuracy", "best_accuracy", "sim_time", "rounds",
                  "history", "extra"):
        assert getattr(runs[1], field) == getattr(runs[0], field), field


@pytest.mark.parametrize("cohort_size", [1, 3])
@pytest.mark.parametrize("scenario", ["poison", "lazy", "straggler",
                                      "dropout"])
def test_scenario_counts_match_reference(world, scenario, cohort_size):
    ref = JCoord(world["j_backend"], world["data"], world["test"],
                 JConfig(scenario=scenario, **_dag_kw(cohort_size)),
                 JCost(local_epoch=2.0), make_profiles(3, 0.5, 0)).run(
        jax.random.PRNGKey(0))
    _, got = _port_dag(world, scenario, cohort_size)
    assert got.extra["scenario"] == ref.extra["scenario"] == scenario
    assert got.extra["scenario_counts"] == ref.extra["scenario_counts"]
    assert got.rounds == ref.rounds
    assert got.extra["chain_len"] == ref.extra["chain_len"] == 1 + got.rounds
    assert got.extra["cohorts_dispatched"] == ref.extra["cohorts_dispatched"]
    assert (got.extra["cohorts_dispatched"] > 0) == (cohort_size > 1)
    key = {"poison": "updates_scaled", "lazy": "updates_lazy",
           "straggler": "straggler_draws",
           "dropout": "publishes_dropped"}[scenario]
    assert got.extra["scenario_counts"][key] > 0


@pytest.mark.parametrize("name", ["fedavg", "fedasync"])
def test_poisoned_baseline_counts_match_reference_on_the_cohort(world, name):
    kw = dict(n_clients=3, max_rounds=2, local_epochs=1, seed=0,
              patience=10 ** 6, cohort_size=3, cohort_window=2.0)
    sc_ref, sc_got = J.Scenario(J.SCENARIOS["poison"], 3), \
        T.Scenario(T.SCENARIOS["poison"], 3)
    ref = J.ALGORITHMS[name](world["j_backend"], world["data"],
                             world["test"], J.FLConfig(scenario=sc_ref, **kw),
                             JCost(local_epoch=2.0), make_profiles(3, 0.5, 0))
    got = T.ALGORITHMS[name](world["t_backend"], world["data"],
                             world["test"], T.FLConfig(scenario=sc_got, **kw),
                             TCost(local_epoch=2.0), make_profiles(3, 0.5, 0),
                             init_model=world["genesis"])
    assert sc_got.counts() == sc_ref.counts()
    assert sc_got.counts()["updates_scaled"] > 0
    assert got.rounds == ref.rounds and got.sim_time == ref.sim_time


def test_dag_attack_metrics_and_tamper_detections_match_on_the_stub():
    data, test, _ = stub_world()
    kw = dict(n_clients=4, max_rounds=5, local_epochs=1, seed=3,
              patience=10 ** 6)
    sc_ref = J.Scenario(J.SCENARIOS["poison"], 4)
    sc_got = T.Scenario(T.SCENARIOS["poison"], 4)
    ref = JCoord(StubBackend(jnp.asarray), data, test,
                 JConfig(scenario=sc_ref, **kw))
    got = DagAflCoordinator(StubBackend(torch.from_numpy), data, test,
                            DagAflConfig(scenario=sc_got, **kw))
    r_ref, r_got = ref.run(), got.run()
    assert _hashes(got) == _hashes(ref)
    assert r_got.extra == r_ref.extra
    assert T.dag_attack_metrics(got.ledger, sc_got) == \
        J.dag_attack_metrics(ref.ledger, sc_ref)
    assert sc_got.tampered == sc_ref.tampered and sc_got.tampered
    assert sorted(detect_tampered(got.ledger)) == sorted(sc_got.tampered) \
        == sorted(j_detect(ref.ledger))
    assert IncrementalVerifier(got.ledger).audit()[0] is False
    assert JVerifier(ref.ledger).audit()[0] is False
