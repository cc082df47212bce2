"""The port's mixture-of-experts layer against the JAX reference, from the
same weights, inputs and router probabilities.

JAX weights are carried over with ``params_from_numpy``; both sides run in
float32.  Tolerances and their reasons:

* dispatch: equal (``np.array_equal``) -- the same greedy top-k over the
  same probabilities, with exact float32 slot positions and ties resolved
  to the first index on both sides;
* gates: 1e-6 relative on the same probabilities -- a sum of at most two
  of them and one true division, rounded alike; 1e-5 relative and 1e-6
  absolute in the layer, where each side routes its own probabilities:
  the router's float32 products differ in the last bits, and logits of
  about 8 (a router drawn at scale 1, so routing is uneven) carry ~1e-6
  relative differences through the softmax;
* the layer's output: 2e-5 absolute at a scale of about 1 -- the two
  frameworks' float32 matrix products differ in the last bits; the routing
  (each side's dispatch, from its own probabilities) is asserted equal,
  so a flip at a near-tie would fail, not hide under the tolerance;
* the router's means (the mean probability, the kept share, the z-loss):
  bit for bit against jitted ``jnp.mean``; ``moe_aux``: 1e-6 relative
  (XLA fuses the E products of the load-balance sum, and the last
  addition, into fused multiply-adds);
* a vmapped call against K single calls: 1e-6 (batched products).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core.aggregate import tree_leaves, tree_map  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

ATOL = 2e-5


def _configs(arch, **moe_kw):
    """The reduced config in both packages (d_model 64, float32), its MoE
    settings replaced by ``moe_kw``."""
    jc = j_reduced(j_get_config(arch), d_model=64)
    tc = reduced(get_config(arch), d_model=64)
    if moe_kw:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe,
                                                             **moe_kw))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe,
                                                             **moe_kw))
    return jc, tc


def _probs(G, Sg, E, seed, ties):
    """Router probabilities (G, S_g, E) float32; with ``ties``, some rows
    uniform (zero logits, as the padded rows) and some with two equal
    largest entries."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((G, Sg, E)) * 1.5).astype(np.float32)
    if ties:
        logits[:, ::5] = 0.0
        logits[:, 1::7, 1] = logits[:, 1::7, E - 1] = 4.0
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    if ties:
        assert np.any(probs[:, 1::7, 1] == probs[:, 1::7, E - 1])
    return probs


# (G, S_g, E, cap): caps that drop tokens and caps that take every token
DISPATCH_CASES = [(2, 24, 4, 3), (2, 24, 4, 24), (1, 40, 16, 2),
                  (1, 40, 16, 40), (3, 17, 8, 1), (1, 64, 128, 1),
                  (1, 33, 5, 80)]


@pytest.mark.parametrize("G,Sg,E,cap", DISPATCH_CASES)
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("ties", [False, True])
def test_topk_dispatch_bit_equal(G, Sg, E, cap, k, ties):
    probs = _probs(G, Sg, E, seed=G * Sg + E + cap, ties=ties)
    j_gates, j_dispatch = j_moe._topk_dispatch(jnp.asarray(probs), k, cap)
    gates, dispatch = moe.topk_dispatch(torch.from_numpy(probs.copy()), k,
                                        cap)
    assert dispatch.dtype == torch.bool and gates.dtype == torch.float32
    assert np.array_equal(dispatch.numpy(), np.asarray(j_dispatch))
    np.testing.assert_allclose(gates.numpy(), np.asarray(j_gates),
                               rtol=1e-6, atol=0)
    taken = int(dispatch.sum())
    if cap * E < G * Sg * k or ties and cap == 1:
        assert taken < G * Sg * k          # the cap dropped choices
    if cap >= Sg:
        assert taken == G * Sg * k         # and this one none


def test_argmax_takes_the_first_of_ties():
    """The routing's tie rule: the first largest index, as ``jnp.argmax``
    (rows of zero logits, the padded rows, go to expert 0)."""
    x = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                  [0.3, 0.2, 0.3, 0.2], [0.0, 0.0, 0.5, 0.5]], np.float32)
    want = np.asarray(jnp.argmax(jnp.asarray(x), axis=-1))
    assert np.array_equal(torch.from_numpy(x).argmax(-1).numpy(), want)
    assert want.tolist() == [0, 1, 0, 2]


@pytest.mark.parametrize("group,S,k,E,cf,generous", [
    (512, 512, 2, 16, 1.25, False), (512, 512, 2, 16, 1.25, True),
    (8, 1, 2, 16, 1.25, False), (148, 37, 1, 4, 1.25, False),
    (100, 50, 2, 4, 0.5, False), (3, 1, 1, 128, 1.25, False),
    (512, 512, 1, 128, 1.25, True)])
def test_capacity_is_the_references(group, S, k, E, cf, generous):
    """The reference's rule, written in its ``moe_forward``; at Jamba's
    width a 512-token group keeps 80 slots an expert in training and 256
    in serving."""
    mo = MoEConfig(n_experts=E, top_k=k, d_expert=8, capacity_factor=cf)
    if S == 1 or generous:
        want = min(group, max(8, -(-group * k * 4 // E)))
    else:
        want = max(int(group * k / E * cf), 1)
    assert moe.capacity(group, S, mo, generous) == want
    assert moe.capacity(512, 512, MoEConfig(16, 2, 8), False) == 80
    assert moe.capacity(512, 512, MoEConfig(16, 2, 8), True) == 256


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b",
                                  "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_moe_tree_matches_reference(arch, dtype):
    """Leaf names, shapes and dtypes (llama4's shared expert an
    ``init_mlp`` tree), and the JAX tree loads unchanged."""
    jc, tc = _configs(arch)
    want = jax.eval_shape(
        lambda k: j_moe.init_moe(k, jc, jnp.dtype(dtype)),
        jax.random.PRNGKey(0))
    got = moe.init_moe(torch.Generator().manual_seed(0), tc,
                       getattr(torch, dtype))
    j_leaves, j_tree = jax.tree_util.tree_flatten(want)
    assert [tuple(a.shape) for a in tree_leaves(got)] == \
        [a.shape for a in j_leaves]
    assert [str(a.dtype).split(".")[-1] for a in tree_leaves(got)] == \
        [str(a.dtype) for a in j_leaves]
    assert ("shared" in got) == (jc.moe.n_shared > 0)
    loaded = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, j_moe.init_moe(jax.random.PRNGKey(0), jc,
                                   jnp.float32)), "cpu")
    assert sorted(loaded) == sorted(got)


def _layer(jc, seed, router_scale):
    """The reference's MoE tree at ``jc``, its router drawn at
    ``router_scale`` (larger routes less evenly, so training capacity
    drops tokens), as numpy."""
    params = jax.tree_util.tree_map(
        np.array, j_moe.init_moe(jax.random.PRNGKey(seed), jc, jnp.float32))
    rng = np.random.default_rng(seed)
    params["router"] = (rng.standard_normal(params["router"].shape)
                        * router_scale).astype(np.float32)
    return params


def _capture(monkeypatch, module, name, store):
    inner = getattr(module, name)

    def wrapper(*args, **kwargs):
        out = inner(*args, **kwargs)
        store.append(out)
        return out

    monkeypatch.setattr(module, name, wrapper)


# (arch, B, S, generous, capacity_factor): training capacity at the
# published 1.25 and at 0.5 (which drops tokens), generous capacity, one
# token a row, and B*S past one 512-token group (the padded tail);
# llama4's shared expert beside jamba's none
MOE_CASES = [("jamba-v0.1-52b", 2, 24, False, 1.25),
             ("jamba-v0.1-52b", 2, 24, False, 0.5),
             ("jamba-v0.1-52b", 2, 24, True, 1.25),
             ("jamba-v0.1-52b", 5, 1, False, 1.25),
             ("jamba-v0.1-52b", 3, 200, False, 0.5),
             ("jamba-v0.1-52b", 3, 200, True, 1.25),
             ("llama4-maverick-400b-a17b", 2, 24, False, 0.5),
             ("llama4-maverick-400b-a17b", 2, 24, True, 1.25),
             ("llama4-maverick-400b-a17b", 4, 1, False, 1.25),
             ("llama4-maverick-400b-a17b", 3, 200, False, 1.25)]


@pytest.mark.parametrize("arch,B,S,generous,factor", MOE_CASES)
def test_moe_forward_matches_reference(monkeypatch, arch, B, S, generous,
                                       factor):
    jc, tc = _configs(arch, capacity_factor=factor)
    np_params = _layer(jc, seed=B * S, router_scale=1.0)
    x = np.random.default_rng(S).normal(size=(B, S, 64)).astype(np.float32)
    j_routes, t_routes = [], []
    _capture(monkeypatch, j_moe, "_topk_dispatch", j_routes)
    _capture(monkeypatch, moe, "topk_dispatch", t_routes)
    j_out, j_aux = j_moe.moe_forward(
        jax.tree_util.tree_map(jnp.asarray, np_params), jnp.asarray(x),
        cfg=jc, generous_capacity=generous)
    with torch.no_grad():
        out, aux = moe.moe_forward(params_from_numpy(np_params, "cpu"),
                                   torch.from_numpy(x), cfg=tc,
                                   generous_capacity=generous)
    (j_gates, j_dispatch), = j_routes
    (gates, dispatch), = t_routes
    assert np.array_equal(dispatch.numpy(), np.asarray(j_dispatch))
    np.testing.assert_allclose(gates.numpy(), np.asarray(j_gates),
                               rtol=1e-5, atol=1e-6)
    assert dispatch.shape[0] == -(-B * S // 512)
    if factor < 1 and not generous:
        routed = dispatch.shape[0] * dispatch.shape[1] * tc.moe.top_k
        assert int(dispatch.sum()) < routed      # tokens were dropped
    assert out.shape == (B, S, 64) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0,
                               atol=ATOL)
    assert np.array_equal(aux["expert_load"].numpy(),
                          np.asarray(j_aux["expert_load"]))
    assert float(aux["moe_aux"]) == pytest.approx(float(j_aux["moe_aux"]),
                                                  rel=1e-6)


def _reference_losses(probs, kept, z, E, w, w_z):
    """The reference's router losses (``moe_forward``'s last lines), with
    the logsumexp z given."""
    me = jnp.mean(probs.reshape(-1, E), axis=0)
    ce = jnp.mean(kept.reshape(-1, E).astype(jnp.float32), axis=0)
    aux_lb = E * jnp.sum(me * ce) * w
    aux_z = jnp.mean(jnp.square(z)) * w_z
    return {"moe_aux": aux_lb + aux_z, "router_prob": me,
            "expert_load": ce, "z_loss": aux_z}


# (G, S_g, E): one group, 8 full groups of 512 (the card's batch), a
# group past 32 tokens, 128 experts
LOSS_CASES = [(1, 24, 4), (1, 148, 4), (2, 512, 16), (8, 512, 16),
              (1, 40, 8), (3, 512, 4), (1, 512, 128), (1, 7, 128)]


@pytest.mark.parametrize("G,Sg,E", LOSS_CASES)
def test_router_means_are_the_reference_bits(G, Sg, E):
    """The three means of the router losses against the jitted reference,
    bit for bit, on the same probabilities, kept choices and z."""
    rng = np.random.default_rng(G * Sg * E)
    logits = (rng.standard_normal((G, Sg, E)) * 0.5).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    kept = rng.random((G, Sg, E)) < 0.4
    z = np.asarray(jax.scipy.special.logsumexp(jnp.asarray(logits), -1))
    mo = MoEConfig(n_experts=E, top_k=2, d_expert=8)
    want = jax.jit(lambda p, k, zz: _reference_losses(
        p, k, zz, E, mo.router_aux_weight, mo.router_z_weight))(
            probs, kept, z)
    got = moe.router_losses(torch.from_numpy(probs.copy()),
                            torch.from_numpy(kept.copy()),
                            torch.from_numpy(z.copy()), mo)
    for name in ("router_prob", "expert_load", "z_loss"):
        assert np.array_equal(got[name].numpy(), np.asarray(want[name])), \
            name
    assert float(got["moe_aux"]) == pytest.approx(float(want["moe_aux"]),
                                                  rel=1e-6)
    # a division, or torch's own sum, gives other bits for these means
    p = torch.from_numpy(probs.copy()).reshape(-1, E)
    if G * Sg > 32:
        assert not torch.equal(p.sum(0) / (G * Sg), got["router_prob"]) or \
            not torch.equal(p.mean(0), got["router_prob"])


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b",
                                  "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("generous", [False, True])
def test_vmapped_layer_equals_single_calls(arch, generous):
    """``torch.func.vmap`` over K stacked layers and inputs (the LM cohort
    engine's training), values and gradients, against K single calls."""
    jc, tc = _configs(arch)
    K = 3
    trees = [params_from_numpy(_layer(jc, seed=s, router_scale=1.0), "cpu")
             for s in range(K)]
    stacked = tree_map(lambda *a: torch.stack(a), *trees)
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(K, 2, 24, 64)).astype(np.float32))

    def one(params, xk):
        out, aux = moe.moe_forward(params, xk, cfg=tc,
                                   generous_capacity=generous)
        return out, aux["moe_aux"], aux["expert_load"]

    stacked = tree_map(lambda a: a.requires_grad_(True), stacked)
    outs, auxes, loads = torch.func.vmap(one)(stacked, x)
    (outs.square().sum() + auxes.sum()).backward()
    for k in range(K):
        params = tree_map(lambda a: a.detach().clone().requires_grad_(True),
                          trees[k])
        out, aux, load = one(params, x[k])
        (out.square().sum() + aux).backward()
        torch.testing.assert_close(outs[k], out, rtol=0, atol=1e-6)
        torch.testing.assert_close(auxes[k], aux, rtol=1e-6, atol=0)
        assert torch.equal(loads[k], load)
        for a, b in zip(tree_leaves(stacked), tree_leaves(params)):
            torch.testing.assert_close(a.grad[k], b.grad, rtol=1e-5,
                                       atol=1e-6)
