"""The DAG-AFL loop over deepseek-v2's MLA and MoE cut, gemma3-27b's
period and qwen2-vl-72b's layer, the port against the JAX reference, as
``chip_smoke.py``'s ``dag_mla``, ``dag_gemma3`` and ``dag_qwen2vl`` legs
run them on the card at full width.

The worlds are ``test_torch_lm_backend.py``'s LM world (batch 8, 64
positions, a 128-token vocabulary, 2 local SGD steps a round; batch 4 for
gemma3's six layers, which keeps the file near a minute on one worker)
over three cuts reduced to d_model 64 in both packages:

* deepseek-v2 as the card leg cuts it: its dense prologue layer, then one
  MLA layer over a MoE feed-forward (4 experts, top-2, a shared expert);
* gemma3-27b's published period, five local layers and a global one, the
  local window 8, which the 64 positions pass;
* qwen2-vl-72b cut to one layer, as the card leg cuts it: M-RoPE sections
  and QKV biases at ``test_torch_mrope.py``'s head_dim of 128.  The loop
  feeds text positions, (3, B, S) rows alike, in every forward it makes
  (evaluation, signature, training), as the reference's backend does.

The JAX weights are carried over by ``params_from_numpy``; both sides run in
float32, the reference's eval and signature forwards on its interpret-mode
kernels, the port's on their plain versions.  Every comparison is an
equality, as in ``test_torch_lm_backend._coordinator_runs_agree``: the
same tip decisions (publisher, approved parents, accuracy and signature of
every transaction), rounds, ``chain_len``, verification and final
accuracy; a store in host memory gives the default store's ledger, Eq. 7
hashes, results and final global model bit for bit.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.configs.base import LayerSpec as JLayerSpec  # noqa: E402
from repro.configs.base import Stage as JStage  # noqa: E402
from repro.core.coordinator import DagAflConfig as JConfig  # noqa: E402
from repro.core.coordinator import DagAflCoordinator as JCoord  # noqa: E402
from repro.data import make_lm_dataset  # noqa: E402
from repro.fl.backend import LMBackend as JBackend  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import LayerSpec, Stage  # noqa: E402
from repro_torch.core.aggregate import tree_leaves  # noqa: E402
from repro_torch.core.coordinator import DagAflConfig, DagAflCoordinator  # noqa: E402
from repro_torch.core.verify import verify_full_dag  # noqa: E402
from repro_torch.fl.backend import LMBackend  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402
from test_torch_baselines import few_torch_threads  # noqa: E402,F401
from test_torch_coordinator import StubBackend, _stub_world  # noqa: E402
from test_torch_lm_backend import KW, _jax_params, _streams, _tip_decisions  # noqa: E402
from test_torch_mrope import _configs as _mrope_configs  # noqa: E402


def _mla_configs():
    """deepseek-v2 reduced, cut as ``chip_smoke.mla_config`` cuts it: the
    dense prologue stage, then one layer of the MoE stage."""
    jc = j_reduced(j_get_config("deepseek-v2-236b"), d_model=64)
    tc = reduced(get_config("deepseek-v2-236b"), d_model=64)
    jc = dataclasses.replace(jc, n_layers=2, vocab_size=128, stages=(
        JStage((JLayerSpec(kind="attn", ffn="dense"),), 1),
        JStage((JLayerSpec(kind="attn", ffn="moe"),), 1)))
    tc = dataclasses.replace(tc, n_layers=2, vocab_size=128, stages=(
        Stage((LayerSpec(kind="attn", ffn="dense"),), 1),
        Stage((LayerSpec(kind="attn", ffn="moe"),), 1)))
    return jc, tc


def _gemma3_configs():
    """gemma3-27b reduced to one published period, 5 local layers of
    window 8, then a global one."""
    jc = j_reduced(j_get_config("gemma3-27b"), d_model=64)
    tc = reduced(get_config("gemma3-27b"), d_model=64)
    jc = dataclasses.replace(jc, n_layers=6, vocab_size=128, stages=(JStage(
        (JLayerSpec(window=8),) * 5 + (JLayerSpec(),), 1),))
    tc = dataclasses.replace(tc, n_layers=6, vocab_size=128, stages=(Stage(
        (LayerSpec(window=8),) * 5 + (LayerSpec(),), 1),))
    return jc, tc


def _qwen2_vl_configs():
    """qwen2-vl-72b reduced (head_dim 128, vocabulary 128), cut as
    ``chip_smoke.mrope_config`` cuts it: one layer."""
    jc, tc = _mrope_configs(vocab=128)
    jc = dataclasses.replace(jc, n_layers=1, stages=(
        JStage(jc.stages[0].pattern, 1),))
    tc = dataclasses.replace(tc, n_layers=1, stages=(
        Stage(tc.stages[0].pattern, 1),))
    return jc, tc


# each cut's configs (reference, port) and backend arguments
CONFIGS = {"mla": (_mla_configs, KW),
           "gemma3": (_gemma3_configs, dict(KW, batch_size=4)),
           "qwen2_vl": (_qwen2_vl_configs, KW)}


def test_cuts_are_the_card_legs_block_kinds():
    jc, tc = _mla_configs()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert [(s.kind, s.ffn) for s in tc.layer_specs()] == [
        ("attn", "dense"), ("attn", "moe")]
    assert tc.mla is not None and tc.moe.n_shared == 1
    jc, tc = _gemma3_configs()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert [s.window for s in tc.layer_specs()] == [8] * 5 + [-1]
    jc, tc = _qwen2_vl_configs()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert [(s.kind, s.ffn, s.window) for s in tc.layer_specs()] == [
        ("attn", "dense", -1)]
    assert tc.mrope_sections == (16, 24, 24) and tc.qkv_bias
    assert sum(tc.mrope_sections) == tc.head_dim // 2


def _world(n_clients):
    data = [{"train": s, "val": s, "test": s} for s in _streams(n_clients)]
    test = make_lm_dataset(vocab=128, n_tokens=6000, order=2.0, seed=10_000)
    return data, test


def _port_run(name, n_clients, max_rounds, store_device=None):
    configs, kw = CONFIGS[name]
    _, tc = configs()
    data, test = _world(n_clients)
    coord = DagAflCoordinator(
        LMBackend(tc, device="cpu", **kw), data, test,
        DagAflConfig(n_clients=n_clients, max_rounds=max_rounds,
                     local_epochs=2, seed=0), store_device=store_device)
    return coord, coord.run(params_from_numpy(_jax_params(tc), "cpu"))


@functools.lru_cache(maxsize=None)
def _default_run(name):
    """The port's 3-client, 2-round run with the default store, shared by
    the reference comparison and the host-memory store's."""
    return _port_run(name, 3, 2)


def _ref_run(name, n_clients, max_rounds):
    configs, kw = CONFIGS[name]
    jc, _ = configs()
    data, test = _world(n_clients)
    ref = JCoord(JBackend(jc, kernel_policy="interpret", **kw), data, test,
                 JConfig(kernel_policy="interpret", n_clients=n_clients,
                         max_rounds=max_rounds, local_epochs=2, seed=0))
    return ref, ref.run(jax.random.PRNGKey(0))


def _agree(got, r_got, ref, r_ref, rounds):
    assert r_got.rounds == r_ref.rounds == rounds
    assert r_got.extra["chain_len"] == r_ref.extra["chain_len"] == 1 + rounds
    assert r_got.extra["verify_failures"] == 0
    assert verify_full_dag(got.ledger) == (True, "ok")
    assert _tip_decisions(got) == _tip_decisions(ref)
    assert r_got.final_accuracy == r_ref.final_accuracy


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_coordinator_runs_agree(name):
    """Three clients, two rounds each: the port's loop (the eval and
    signature forwards on MLA's head dim of 48, the local layers' window,
    or M-RoPE's three position rows) against the reference's."""
    got, r_got = _default_run(name)
    ref, r_ref = _ref_run(name, 3, 2)
    _agree(got, r_got, ref, r_ref, rounds=6)


def test_one_round_on_two_clients_agrees():
    """``dag_mla``'s world: 2 clients of one round each, so both train
    from the genesis and the final sweep reads their only models."""
    got, r_got = _port_run("mla", 2, 1)
    ref, r_ref = _ref_run("mla", 2, 1)
    _agree(got, r_got, ref, r_ref, rounds=2)


def _outcome(coord, result) -> tuple:
    txs = sorted(coord.ledger.transactions(), key=lambda t: t.seq)
    return (_tip_decisions(coord), [t.tx_hash for t in txs],
            result.final_accuracy, result.best_accuracy, result.rounds,
            result.history, result.sim_time,
            {k: result.extra[k] for k in (
                "tip_mean_accuracy", "client_mean_accuracy", "chain_len",
                "tip_evaluations", "store_bytes_transferred")})


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_store_in_host_memory_is_bit_equal(name):
    """The legs' store (``store_device="cpu"``): every published model
    rests in host memory and is copied to the backend's device when read;
    on the CPU the copies change nothing, so the run equals the default
    store's to the bit."""
    card, r_card = _default_run(name)
    host, r_host = _port_run(name, 3, 2, store_device="cpu")
    assert _outcome(host, r_host) == _outcome(card, r_card)
    readings = host.store.readings()
    assert readings["resting_devices"] == ["cpu"]
    assert len(host.store) == 7            # the genesis and 6 published
    assert readings["peak_resting_bytes"] == readings["resting_bytes"]
    a, b = tree_leaves(host.global_model()), tree_leaves(card.global_model())
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _store_peak(coord) -> list:
    """Wraps ``coord.store.put`` to record the store's largest size."""
    peak, put = [0], coord.store.put

    def counted(key, model):
        ref = put(key, model)
        peak[0] = max(peak[0], len(coord.store))
        return ref
    coord.store.put = counted
    return peak


@pytest.mark.parametrize("clients,rounds,peak,pruned",
                         [(2, 1, 3, 1), (2, 2, 4, 2)])
def test_bounded_ledger_keeps_the_genesis(clients, rounds, peak, pruned):
    """The bounded ledger (``ledger_checkpoint_every``) at the card legs'
    worlds, on the stub backend: the store peaks at ``peak`` of the 1 +
    clients x rounds models in both packages (no saving at ``dag_mla``'s
    2 x 1, one model at ``dag_gemma3``'s 2 x 2, at cadences of 1 to 20
    simulated seconds alike) and keeps them to the end, and the genesis's
    model is never evicted: pruned while it is client -1's latest, its
    eviction waits for a publish that never comes."""
    data, test = _stub_world(clients)
    for cadence in (1.0, 10.0, 20.0):
        kw = dict(n_clients=clients, max_rounds=rounds, local_epochs=1,
                  seed=3, ledger_checkpoint_every=cadence)
        ref = JCoord(StubBackend(jnp.asarray), data, test, JConfig(**kw))
        got = DagAflCoordinator(StubBackend(torch.from_numpy), data, test,
                                DagAflConfig(**kw))
        ref_peak, got_peak = _store_peak(ref), _store_peak(got)
        ref.run()
        got.run()
        assert got_peak == ref_peak == [peak]
        assert len(got.store) == len(ref.store) == peak
        assert got.ledger.n_pruned == ref.ledger.n_pruned == pruned
        assert got._deferred_evict == ref._deferred_evict == {-1: "genesis"}
        assert "genesis" in got.store and "genesis" in ref.store



@pytest.mark.parametrize("backend", ["lm", "cnn"])
def test_train_local_frees_each_steps_gradients(monkeypatch, backend):
    """A local step's gradients are gone before the next step's forward:
    held through its backward, they are a fourth float32 copy of the
    model beside the parameters, the new gradients and SGD's momentum (on
    an H100, with them held, deepseek-v2's cut runs out of memory at 8, 4
    and 1 x 512, and Jamba's MoE cut peaks at 62.5 GB at 8 x 512 against
    47.8 GB; ``chip_probes.py grads``)."""
    import weakref

    from repro_torch.configs.cnn import vgg_for
    from repro_torch.data.synthetic import make_benchmark_dataset
    from repro_torch.fl.backend import CNNBackend
    from repro_torch.models import cnn as cnn_mod
    from repro_torch.models import transformer as tfm
    if backend == "lm":
        _, tc = _mla_configs()
        b = LMBackend(tc, device="cpu", **KW)
        params, data, steps = b.init(torch.Generator()), _streams(1)[0], 2
        module, loss_name = tfm, "loss_fn"
    else:
        b = CNNBackend(vgg_for("mnist"), local_epochs=1, batch_size=32,
                       device="cpu")
        data = make_benchmark_dataset("mnist", 96)
        params, steps = b.init(torch.Generator()), 3
        module, loss_name = cnn_mod, "cnn_loss"
    held, losses, update = [], [], b.opt.update
    inner_loss = getattr(module, loss_name)

    def loss(*a, **kw):
        losses.append(sum(r() is not None for r in held))
        return inner_loss(*a, **kw)

    def kept(grads, *a, **kw):
        held.extend(weakref.ref(g) for g in tree_leaves(grads))
        return update(grads, *a, **kw)
    monkeypatch.setattr(module, loss_name, loss)
    monkeypatch.setattr(b, "opt", b.opt._replace(update=kept))
    b.train_local(params, data, seed=0)
    assert len(losses) == steps and losses == [0] * steps
    assert held and all(r() is None for r in held)
