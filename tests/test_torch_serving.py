"""Live-traffic consensus serving in the port (``repro_torch.fl.serving``),
and against the JAX reference (``repro.fl.serving``).

(A) The reference's own properties, on the port: a query never observes a
half-written replica (whatever the interleaving of publish cadence and
round arrivals, the replica's params equal a fresh Eq. 6 aggregate over
its OWN pinned refs); same seed + config => identical replica versions,
frontiers and staleness counters; refs pinned by a live replica survive
bounded-ledger pruning and are evicted on the swap that unpins them;
recurring streams never keep a drained simulation alive.  A synthetic
ledger world of tiny torch trees drives the event loop densely.

(B) Across the packages, on the baselines' numpy stub backend
(``test_torch_baselines.StubBackend``): the coordinator's
``extra["serving"]`` equals the reference's counter for counter (all but
the wall-clock ``query_wall_s`` and ``queries_per_s``), sequentially and
on the cohort engine's windows; serving on or off leaves the ledger and
every model bit-identical.  An LM frontier replica decodes the same
tokens as a direct Eq. 6 aggregate, and as the reference's driver on the
same prompts and weights.  An LM coordinator serves on both engines.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.fl.serving as JS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.core.coordinator import DagAflConfig as JConfig  # noqa: E402
from repro.core.coordinator import DagAflCoordinator as JCoord  # noqa: E402
from repro.core.simulator import CostModel as JCost  # noqa: E402
from repro.core.simulator import make_profiles  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.cnn import VGG_TINY  # noqa: E402
from repro_torch.core.coordinator import DagAflConfig, DagAflCoordinator  # noqa: E402
from repro_torch.core.dag import (BoundedDAGLedger, DAGLedger,  # noqa: E402
                                  ModelStore, TxMetadata)
from repro_torch.core.simulator import CostModel, EventLoop  # noqa: E402
from repro_torch.fl.backend import CNNBackend, LMBackend  # noqa: E402
from repro_torch.fl.serving import (CNNQueryDriver, ConsensusPublisher,  # noqa: E402
                                    LMQueryDriver, QueryStream,
                                    ServingConfig, consensus_over_refs,
                                    frontier_snapshot, make_query_driver,
                                    replica_parity, trees_bitwise_equal)
from repro_torch.weights import params_from_numpy  # noqa: E402
from test_torch_baselines import StubBackend, StubData, stub_world  # noqa: E402
from test_torch_baselines import few_torch_threads  # noqa: E402,F401

WALL = ("query_wall_s", "queries_per_s")


def _meta(cid, epoch=0):
    return TxMetadata(client_id=cid, signature=(0.0,) * 16,
                      model_accuracy=0.5, current_epoch=epoch,
                      validation_node_id=cid)


def _model(v: float):
    return {"w": torch.full((3,), float(v)),
            "b": torch.tensor([float(v) * 2.0])}


class _World:
    """Synthetic training world: appends distinct-valued models on a
    schedule, no backend."""

    def __init__(self, bounded=False, checkpoint_interval=0):
        self.loop = EventLoop()
        self.store = ModelStore()
        self.evicted = []
        if bounded:
            self.ledger = BoundedDAGLedger(
                checkpoint_interval=checkpoint_interval,
                evict_fn=self._on_prune)
        else:
            self.ledger = DAGLedger()
        self.publisher = None
        ref = self.store.put("genesis", _model(0.0))
        self.ledger.add_genesis(_meta(-1), 0.0, ref)
        self._next_val = 1.0

    def _on_prune(self, tx):
        # the coordinator's _evict_model chokepoint, miniaturized
        if self.publisher is not None and \
                self.publisher.guard_evict(tx.model_ref):
            return
        self.store.evict(tx.model_ref)
        self.evicted.append(tx.model_ref)

    def append(self, client: int, parents=None) -> str:
        v = self._next_val
        self._next_val += 1.0
        ref = self.store.put(f"m{int(v):06d}", _model(v))
        if parents is None:
            parents = tuple(self.ledger.tips()) or (self.ledger.genesis_id,)
        tx = self.ledger.add_transaction(_meta(client), tuple(parents),
                                         self.loop.now, ref)
        return tx.tx_id

    def schedule_appends(self, times, clients=None):
        for i, t in enumerate(times):
            c = clients[i] if clients is not None else i % 3
            self.loop.schedule(t, lambda c=c: self.append(c))


class _ProbeDriver:
    """Query driver that asserts replica integrity on every serve."""

    def __init__(self, store):
        self.store = store
        self.queries = 0
        self.versions = []

    def serve(self, replica):
        assert trees_bitwise_equal(
            replica.params, consensus_over_refs(self.store,
                                                replica.model_refs))
        assert len(replica.frontier) == len(replica.model_refs) > 0
        self.versions.append(replica.version)
        self.queries += 1
        return {}

    def report(self):
        return {"driver": "probe"}


# -- (A) the reference's properties, on the port -------------------------------


def test_serving_config_is_the_references_without_kernel_policy():
    ref = {f.name: f.default for f in dataclasses.fields(JS.ServingConfig)}
    got = {f.name: f.default for f in dataclasses.fields(ServingConfig)}
    assert set(ref) - set(got) == {"kernel_policy"}
    assert all(got[k] == ref[k] for k in got)


def test_two_streams_do_not_keep_drained_loop_alive():
    loop = EventLoop()
    a, b = [], []
    loop.schedule(5.0, lambda: None)           # the only real work
    loop.schedule_every(1.0, lambda: a.append(loop.now))
    loop.schedule_every(1.3, lambda: b.append(loop.now))
    loop.run(max_events=10_000)
    assert loop.now < 10.0
    assert all(t <= loop.now for t in a + b)
    assert len(a) + len(b) < 20


def test_publish_noop_when_frontier_unchanged():
    w = _World()
    pub = ConsensusPublisher(w.ledger, w.store, w.loop, every=1.0)
    assert pub.publish() is not None           # v0: genesis frontier
    assert pub.publish() is None               # nothing appended
    assert (pub.publishes, pub.publishes_noop) == (1, 1)
    rep = pub.replica()
    assert rep.version == 0 and rep.frontier == (w.ledger.genesis_id,)
    w.append(0)
    rep2 = pub.publish()
    assert rep2 is not None and rep2.version == 1
    assert pub.replica() is rep2               # swap flipped the buffer
    assert rep.params is not None              # old replica left intact


def test_replica_is_exact_eq6_aggregate():
    w = _World()
    g = w.ledger.genesis_id
    for c in (0, 1, 2):                        # three branches off genesis
        w.append(c, parents=(g,))
    pub = ConsensusPublisher(w.ledger, w.store, w.loop, every=1.0)
    rep = pub.publish()
    assert set(rep.frontier) == set(w.ledger.tips())
    assert replica_parity(rep, w.store)
    assert torch.equal(rep.params["w"], torch.full((3,), 2.0))


def test_trees_bitwise_equal_is_exact():
    a = {"w": torch.tensor([1.0, 2.0]), "b": [torch.tensor([3.0])]}
    b = {"w": torch.tensor([1.0, np.nextafter(np.float32(2), 3)]),
         "b": [torch.tensor([3.0])]}
    assert trees_bitwise_equal(a, a)
    assert not trees_bitwise_equal(a, b)
    assert not trees_bitwise_equal(a, {"w": a["w"]})


def test_eviction_protection_pins_replica_refs_until_swap():
    w = _World(bounded=True)
    pub = ConsensusPublisher(w.ledger, w.store, w.loop, every=1.0)
    w.publisher = pub
    g = w.ledger.genesis_id
    for c in (0, 1, 2):
        w.append(c, parents=(g,))
    rep1 = pub.publish()                       # pins the 3-tip frontier
    for c in (0, 1, 2, 0, 1, 2):
        w.append(c)
    w.ledger.checkpoint(now=2.0)
    assert w.ledger.n_pruned > 0
    pinned = set(rep1.model_refs) & set(pub._deferred)
    assert pinned, "checkpoint never tried to evict a pinned replica ref"
    for r in rep1.model_refs:
        assert r in w.store                    # protected while live
    pub.publish()                              # swap 1: rep1 in back buffer
    for r in rep1.model_refs:
        assert r in w.store                    # back slot still pins
    w.append(0)
    pub.publish()                              # swap 2: rep1 fully unpinned
    for r in pinned:
        assert r not in w.store                # released and evicted
    assert pub.evictions_released >= len(pinned)
    assert pub.evictions_deferred >= len(pinned)


def test_publisher_start_publishes_v0_immediately():
    w = _World()
    pub = ConsensusPublisher(w.ledger, w.store, w.loop, every=5.0)
    w.schedule_appends([1.0, 2.0, 9.0])
    probe = _ProbeDriver(w.store)
    qs = QueryStream(pub, probe, w.loop, w.ledger, query_rate=1.0, seed=7)
    pub.start()
    qs.start()
    assert pub.replica() is not None           # before any event ran
    w.loop.run()
    assert qs.skipped == 0
    assert probe.queries == qs.queries > 0
    assert probe.versions == sorted(probe.versions)


def test_publisher_rejects_nonpositive_cadence():
    w = _World()
    with pytest.raises(ValueError):
        ConsensusPublisher(w.ledger, w.store, w.loop, every=0.0)
    with pytest.raises(ValueError):
        QueryStream(ConsensusPublisher(w.ledger, w.store, w.loop, 1.0),
                    _ProbeDriver(w.store), w.loop, w.ledger,
                    query_rate=0.0, seed=0)


@settings(max_examples=15, deadline=None)
@given(st.floats(0.3, 4.0),
       st.lists(st.floats(0.1, 12.0), min_size=1, max_size=14),
       st.integers(0, 2 ** 20),
       st.booleans())
def test_replica_never_mixes_frontiers(every, arrival_times, seed, bounded):
    """Whatever the publish-cadence / round-arrival interleaving, every
    query sees a replica whose params are EXACTLY the Eq. 6 aggregate of
    its own frontier refs — never a mixture of two frontiers."""
    w = _World(bounded=bounded, checkpoint_interval=4 if bounded else 0)
    pub = ConsensusPublisher(w.ledger, w.store, w.loop, every=every)
    w.publisher = pub
    w.schedule_appends(sorted(arrival_times))
    probe = _ProbeDriver(w.store)
    qs = QueryStream(pub, probe, w.loop, w.ledger, query_rate=2.0, seed=seed)
    pub.start()
    qs.start()
    w.loop.run(max_events=50_000)
    assert qs.skipped == 0
    assert probe.versions == sorted(probe.versions)
    assert all(lag >= 0 for lag in qs.seq_lags)
    assert all(t >= 0.0 for t in qs.time_lags)
    assert set(qs.version_hist) <= set(range(pub.publishes))


def _run_synthetic(seed: int, every=1.7, rate=1.5, bounded=True):
    w = _World(bounded=bounded, checkpoint_interval=0)
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(1.0, size=12))
    swaps = []
    pub = ConsensusPublisher(
        w.ledger, w.store, w.loop, every=every,
        on_swap=lambda r: swaps.append((r.version, r.frontier,
                                        r.ledger_seq, r.published_at)))
    w.publisher = pub
    if bounded:
        w.loop.schedule_every(
            2.5, lambda: w.ledger.maybe_checkpoint(now=w.loop.now))
    w.schedule_appends(times.tolist())
    probe = _ProbeDriver(w.store)
    qs = QueryStream(pub, probe, w.loop, w.ledger, query_rate=rate,
                     seed=seed + 1)
    pub.start()
    qs.start()
    w.loop.run(max_events=50_000)
    return swaps, qs.report(), pub.report()


def test_same_seed_same_replica_sequence_and_counters():
    swaps_a, qrep_a, prep_a = _run_synthetic(3)
    swaps_b, qrep_b, prep_b = _run_synthetic(3)
    assert swaps_a == swaps_b
    assert prep_a == prep_b
    assert {k: v for k, v in qrep_a.items() if k not in WALL} == \
           {k: v for k, v in qrep_b.items() if k not in WALL}


def test_different_seed_different_trace():
    _, qrep_a, _ = _run_synthetic(3)
    _, qrep_b, _ = _run_synthetic(4)
    assert (qrep_a["arrivals"] != qrep_b["arrivals"]
            or qrep_a["replica_version_hist"]
            != qrep_b["replica_version_hist"])


def test_make_query_driver_auto_detects_backend():
    from repro_torch.data.synthetic import make_benchmark_dataset
    ds = make_benchmark_dataset("mnist", n_samples=64, seed=0)
    cnn = CNNBackend(VGG_TINY, device="cpu")
    scfg = ServingConfig(backend="auto")
    assert isinstance(make_query_driver(scfg, cnn, ds), CNNQueryDriver)
    lm_cfg = dataclasses.replace(reduced(get_config("internlm2-1.8b"),
                                         d_model=32), vocab_size=64)
    drv = make_query_driver(scfg, LMBackend(lm_cfg, device="cpu"), None)
    assert isinstance(drv, LMQueryDriver)
    with pytest.raises(ValueError):
        make_query_driver(ServingConfig(backend="nope"), cnn, ds)


# -- (B) against the reference --------------------------------------------------


@dataclasses.dataclass
class QueryData(StubData):
    """The stub's global test shard, with the rows the CNN query driver
    slices into windows."""
    x: np.ndarray = None


class ServeStub(StubBackend):
    """The baselines' stub; a query window (rows without a target) is
    scored against the zero target."""

    def evaluate(self, params, ds, limit=512):
        if not hasattr(ds, "target"):
            ds = StubData(np.zeros(8, np.float32), np.float32(1.0), ds.y)
        return super().evaluate(params, ds, limit)


def _stub_world():
    data, _, _ = stub_world()
    test = QueryData(np.zeros(8, np.float32), np.float32(1.0),
                     np.arange(40) % 10, x=np.arange(40, dtype=np.float32))
    return data, test


def _run_stub(pkg, serving, cohort_size=1, bounded=0.0, scenario=None):
    data, test = _stub_world()
    kw = dict(n_clients=4, max_rounds=4, local_epochs=1, patience=10 ** 6,
              seed=0, cohort_size=cohort_size, cohort_window=2.0,
              ledger_checkpoint_every=bounded, scenario=scenario)
    if pkg == "jax":
        kw["serving"] = None if serving is None else JS.ServingConfig(
            **dataclasses.asdict(serving))
        coord = JCoord(ServeStub(jnp.asarray), data, test, JConfig(**kw),
                       JCost(), make_profiles(4, 0.6, 0))
        return coord, coord.run(init_key=jax.random.PRNGKey(0))
    coord = DagAflCoordinator(ServeStub(torch.from_numpy), data, test,
                              DagAflConfig(serving=serving, **kw),
                              CostModel(), make_profiles(4, 0.6, 0))
    return coord, coord.run()


SERVE = ServingConfig(every=3.0, query_rate=1.5, query_batch=8,
                      backend="cnn", seed=11)


@pytest.mark.parametrize("bounded", [0.0, 4.0])
@pytest.mark.parametrize("scenario", [None, "straggler"])
def test_stub_serving_counters_equal_reference(scenario, bounded):
    """``extra["serving"]`` of the port equals the reference's, all but
    the wall-clock readings, and the rest of the run's result too."""
    _, ref = _run_stub("jax", SERVE, bounded=bounded, scenario=scenario)
    coord, got = _run_stub("torch", SERVE, bounded=bounded,
                           scenario=scenario)
    want = {k: v for k, v in ref.extra["serving"].items() if k not in WALL}
    have = {k: v for k, v in got.extra["serving"].items() if k not in WALL}
    assert have == want
    assert have["queries"] > 0 and have["skipped"] == 0
    assert sum(have["replica_version_hist"].values()) == have["queries"]
    for field in ("rounds", "sim_time", "history", "final_accuracy"):
        assert getattr(got, field) == getattr(ref, field), field
    assert replica_parity(coord.publisher.replica(), coord.store)


def test_stub_serving_counters_equal_reference_on_the_cohort_engine():
    """The stub has no cohort suite in either package, so both run the
    windowed coordinator's sequential fallback; with a registered suite
    (the LM test below) the port serves from the engine's windows."""
    _, ref = _run_stub("jax", SERVE, cohort_size=3)
    _, got = _run_stub("torch", SERVE, cohort_size=3)
    assert {k: v for k, v in got.extra["serving"].items() if k not in WALL} \
        == {k: v for k, v in ref.extra["serving"].items() if k not in WALL}


@pytest.mark.parametrize("bounded", [0.0, 4.0])
def test_serving_is_readonly_ledger_bit_identical(bounded):
    """The publisher and the query stream ride the training's event heap
    but mutate nothing of it: the same transactions, parents, hashes and
    models with serving on and off."""
    off, res_off = _run_stub("torch", None, bounded=bounded)
    on, res_on = _run_stub("torch", SERVE, bounded=bounded)
    assert "serving" not in res_off.extra
    assert (res_on.rounds, res_on.sim_time) == (res_off.rounds,
                                                res_off.sim_time)
    txs_on = {t.tx_id: t for t in on.ledger.transactions()}
    assert sorted(txs_on) == sorted(t.tx_id for t in
                                    off.ledger.transactions())
    for t in off.ledger.transactions():
        other = txs_on[t.tx_id]
        assert other.parents == t.parents
        assert on.ledger.hash_of(t.tx_id) == off.ledger.hash_of(t.tx_id)
        if t.model_ref in off.store:
            assert trees_bitwise_equal(off.store.get(t.model_ref),
                                       on.store.get(other.model_ref))


# -- LM replicas ----------------------------------------------------------------


def _lm_cfgs():
    def cut(cfg):
        return dataclasses.replace(cfg, vocab_size=128,
                                   compute_dtype="float32")
    return (cut(j_reduced(j_get_config("internlm2-1.8b"), d_model=64)),
            cut(reduced(get_config("internlm2-1.8b"), d_model=64)))


def _lm_ledger_world(bounded: bool, jc, n_models: int = 3):
    """A frontier of ``n_models`` distinct LM trees (JAX genesis weights)
    branching off genesis; the bounded variant checkpoints, pruning
    genesis."""
    store = ModelStore()
    ledger = (BoundedDAGLedger(evict_fn=lambda tx: store.evict(tx.model_ref))
              if bounded else DAGLedger())

    def weights(seed):
        return params_from_numpy(jax.tree_util.tree_map(
            np.array, j_tfm.init_params(jax.random.PRNGKey(seed), jc)), "cpu")

    ledger.add_genesis(_meta(-1), 0.0, store.put("genesis", weights(99)))
    g = ledger.genesis_id
    for c in range(n_models):
        ledger.add_transaction(_meta(c), (g,), 1.0 + c,
                               store.put(f"m{c}", weights(c)))
    if bounded:
        ledger.checkpoint(now=10.0)
        assert ledger.n_pruned > 0 and "genesis" not in store
    return ledger, store


@pytest.mark.parametrize("bounded", [False, True])
def test_replica_decode_parity_vs_direct_eq6(bounded):
    """Tokens decoded from a published replica equal those from a direct
    Eq. 6 aggregate over the same frontier, and the reference driver's on
    the same prompts and weights."""
    jc, tc = _lm_cfgs()
    driver = LMQueryDriver(tc, query_batch=2, prompt_len=6, new_tokens=4,
                           seed=0)
    prompts = np.random.default_rng(3).integers(0, tc.vocab_size, (2, 6))
    ledger, store = _lm_ledger_world(bounded, jc)
    pub = ConsensusPublisher(ledger, store, EventLoop(), every=1.0)
    rep = pub.publish()
    _, refs = frontier_snapshot(ledger)
    assert rep.model_refs == refs and len(refs) == 3
    direct = consensus_over_refs(store, refs)
    assert trees_bitwise_equal(rep.params, direct)
    toks_replica = driver.decode_prompts(rep.params, prompts)
    toks_direct = driver.decode_prompts(direct, prompts)
    assert toks_replica.shape == (2, 4)
    np.testing.assert_array_equal(toks_replica, toks_direct)
    j_driver = JS.LMQueryDriver(jc, query_batch=2, prompt_len=6,
                                new_tokens=4, seed=0,
                                kernel_policy="reference")
    j_params = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), rep.params)
    np.testing.assert_array_equal(
        toks_replica, j_driver.decode_prompts(j_params, prompts))


def test_lm_driver_draws_the_references_prompts():
    """The driver's prompt stream is the reference's host RNG, call for
    call, so the same queries reach both packages."""
    jc, tc = _lm_cfgs()
    got = LMQueryDriver(tc, query_batch=3, prompt_len=5, seed=8)
    want = JS.LMQueryDriver(jc, query_batch=3, prompt_len=5, seed=8)
    for _ in range(3):
        a = got.rng.integers(0, tc.vocab_size, (got.batch, got.prompt_len))
        b = want.rng.integers(0, jc.vocab_size, (want.batch,
                                                 want.prompt_len))
        assert np.array_equal(a, b)


@pytest.mark.parametrize("cohort_size", [1, 2])
def test_lm_coordinator_serves_on_both_engines(cohort_size):
    """Reduced internlm2 clients with ``serve_every``: replicas publish
    from genesis on, every query decodes, the last replica is its own
    Eq. 6 aggregate, and the ledger is the one without serving."""
    from repro_torch.data.synthetic import make_lm_dataset
    _, tc = _lm_cfgs()
    streams = [make_lm_dataset(vocab=tc.vocab_size, n_tokens=3000, seed=c)
               for c in range(3)]
    data = [{"train": s, "val": s, "test": s} for s in streams]

    def run(serve_every):
        backend = LMBackend(tc, lr=5e-3, local_steps=1, batch_size=2,
                            seq_len=16, device="cpu")
        cfg = DagAflConfig(n_clients=3, max_rounds=2, local_epochs=1,
                           patience=10 ** 6, seed=0, serve_every=serve_every,
                           cohort_size=cohort_size, cohort_window=2.0,
                           serving=None if not serve_every else ServingConfig(
                               every=serve_every, query_rate=0.5,
                               query_batch=2, prompt_len=6, new_tokens=3))
        coord = DagAflCoordinator(backend, data, streams[0], cfg,
                                  CostModel(), make_profiles(3, 0.6, 0))
        gen = torch.Generator().manual_seed(0)
        return coord, coord.run(init_model=backend.init(gen))

    off, res_off = run(0.0)
    on, res_on = run(4.0)
    serving = res_on.extra["serving"]
    assert serving["driver"] == "lm" and serving["queries"] > 0
    assert serving["skipped"] == 0 and serving["replica_versions"] >= 2
    assert serving["tokens_generated"] == serving["queries"] * 2 * 3
    assert replica_parity(on.publisher.replica(), on.store)
    if cohort_size > 1:
        assert res_on.extra["cohorts_dispatched"] > 0
    assert [t.tx_id for t in on.ledger.transactions()] == \
        [t.tx_id for t in off.ledger.transactions()]
    assert res_on.rounds == res_off.rounds
