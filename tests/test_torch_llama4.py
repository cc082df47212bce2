"""llama4-maverick's own shapes against the JAX reference: a narrow
``(attn, dense), (attn, moe)`` period with 128 routed experts, top-1, one
shared expert, and 10 query heads over 2 KV heads (a GQA group of 5), run
from the port's compute replica.

Weights are the reference's initialisation (numpy), with the router drawn
at scale 1 (``tests/test_torch_moe.py``'s uneven routing), so that
experts overflow their capacity in a prefill.  The port's replica of the
bfloat16 config (``weights.compute_replica``: every leaf that every use
casts to the compute type in bfloat16, the norm scales float32) is read
by the port's float32 steps, casting each leaf at use, as the card's
float32 checks read it; the reference's ``make_serve_prefill``,
``make_serve_decode`` and ``make_eval_step`` run in float32 on the same
values (the replica's leaves widened to float32).  The prefill routes 192
tokens a group with 8 slots an expert and drops choices; a decode step at
batch 8 routes 8 tokens with 8 slots (``models.moe.capacity``: one token
a row gets 4x the balanced load, at least 8), so it keeps every choice.

Tolerances, those of the existing llama4 tests
(``tests/test_torch_decode.py``, ``tests/test_torch_moe.py``): logits and
caches within 2e-5 absolute (the two frameworks' float32 products differ
in the last bits); greedy tokens, each side's routing and the eval step's
accuracy equal.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro.train import step as j_step  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.aggregate import tree_leaves, tree_map  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.runtime import serve_runtime  # noqa: E402
from repro_torch.train import step as t_step  # noqa: E402
from repro_torch.weights import (compute_replica,  # noqa: E402
                                 params_from_numpy, params_to_numpy)

ARCH = "llama4-maverick-400b-a17b"
ATOL = 2e-5
B, PROMPT, STEPS = 8, 24, 4
NARROW = dict(n_heads=10, n_kv_heads=2, head_dim=16)


def _narrow(cfg):
    return dataclasses.replace(
        cfg, **NARROW, moe=dataclasses.replace(cfg.moe, n_experts=128,
                                               top_k=1))


@functools.lru_cache(maxsize=None)
def _world():
    """The configs (the reference's and the port's float32 ones, the
    port's bfloat16 one), the replica, the reference's weights and the
    prompts."""
    jc = _narrow(j_reduced(j_get_config(ARCH), d_model=64))
    tc = _narrow(reduced(get_config(ARCH), d_model=64))
    tc16 = dataclasses.replace(tc, compute_dtype="bfloat16",
                               cache_dtype="bfloat16")
    assert (jc.moe.n_experts, jc.moe.top_k, jc.moe.n_shared) == (128, 1, 1)
    assert jc.n_heads // jc.n_kv_heads == 5
    np_params = jax.tree_util.tree_map(
        np.array, j_tfm.init_params(jax.random.PRNGKey(0), jc))
    for layer in np_params["stages"][0].values():
        if "router" in layer["ffn"]:
            layer["ffn"]["router"] = layer["ffn"]["router"] * 50.0
    replica = compute_replica(params_from_numpy(np_params, "cpu"), tc16)
    widened = params_to_numpy(tree_map(lambda a: a.float(), replica))
    tokens = np.random.default_rng(1).integers(
        0, jc.vocab_size, (B, PROMPT)).astype(np.int32)
    return jc, tc, replica, widened, tokens


def test_replica_rests_in_bfloat16():
    """The narrow model's replica: bfloat16 but the norm scales."""
    replica = _world()[2]
    ffn = replica["stages"][0]["l1"]["ffn"]
    assert ffn["we_gate"].shape == (1, 128, 64, 64)
    assert {a.dtype for a in tree_leaves(replica)} == {torch.bfloat16,
                                                       torch.float32}
    assert ffn["we_gate"].dtype == ffn["shared"]["wg"].dtype \
        == replica["embed"]["embedding"].dtype == torch.bfloat16
    assert replica["final_norm"]["scale"].dtype == torch.float32


class _Routes:
    """Each side's dispatch, routing by routing, while entered; the
    routed choices the port's capacity dropped."""

    def __init__(self):
        self.port, self.ref, self.dropped = [], [], []

    def __enter__(self):
        self.inner = (moe.topk_dispatch, j_moe._topk_dispatch)

        def port(probs, k, cap):
            gates, dispatch = self.inner[0](probs, k, cap)
            self.port.append(dispatch.numpy())
            self.dropped.append(k * probs.shape[0] * probs.shape[1]
                                - int(dispatch.sum()))
            return gates, dispatch

        def ref(probs, k, cap):          # traced inside the stage's scan
            gates, dispatch = self.inner[1](probs, k, cap)
            jax.debug.callback(lambda d: self.ref.append(np.asarray(d)),
                               dispatch)
            return gates, dispatch
        moe.topk_dispatch, j_moe._topk_dispatch = port, ref
        return self

    def __exit__(self, *exc):
        moe.topk_dispatch, j_moe._topk_dispatch = self.inner
        jax.effects_barrier()

    def alike(self) -> bool:
        return len(self.port) == len(self.ref) and all(
            np.array_equal(a, b) for a, b in zip(self.port, self.ref))


def _prefills():
    jc, tc, replica, widened, tokens = _world()
    jp = jax.tree_util.tree_map(jnp.asarray, widened)
    with _Routes() as routes:
        jl, jcache = j_step.make_serve_prefill(jc)(
            jp, {"tokens": jnp.asarray(tokens)})
        tl, tcache = t_step.make_serve_prefill(tc, serve_runtime())(
            replica, {"tokens": torch.from_numpy(tokens)})
    return (jl, jcache), (tl, tcache), routes


def test_prefill_matches_reference():
    """The replica's prefill: the last logits and every cache within
    2e-5 of the reference's, each routing the reference's, with choices
    dropped by the capacity."""
    (jl, jcache), (tl, tcache), routes = _prefills()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL)
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(jcache)]
    got = [a.float().numpy() for a in tree_leaves(tcache)]
    assert [a.shape for a in got] == [a.shape for a in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    assert routes.alike() and sum(routes.dropped) > 0


def test_decode_matches_reference():
    """4 greedy decode steps at batch 8 after the prefill: each step's
    logits within 2e-5 and the same greedy tokens."""
    jc, tc, replica, widened, tokens = _world()
    jp = jax.tree_util.tree_map(jnp.asarray, widened)
    (jl, jcache), (tl, tcache), _ = _prefills()
    jcache = j_serve.extend_caches(jcache, jc, STEPS)
    tcache = t_serve.extend_caches(tcache, tc, STEPS)
    jdec = j_step.make_serve_decode(jc)
    tdec = t_step.make_serve_decode(tc, serve_runtime())
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    ttok = tl.argmax(-1).to(torch.int32)[:, None]
    with _Routes() as routes:
        for s in range(STEPS):
            jnext, jlog, jcache = jdec(jp, jtok, jcache,
                                       jnp.int32(PROMPT + s))
            tnext, tlog, tcache = tdec(replica, ttok, tcache, PROMPT + s)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       rtol=0, atol=ATOL)
            assert np.array_equal(tnext.numpy(), np.asarray(jnext))
            jtok, ttok = jnext[:, None], tnext[:, None]
    assert routes.alike() and routes.dropped == [0] * STEPS


def test_eval_step_matches_reference():
    """The eval step (``mode="prefill"``) on the replica: the accuracy
    equal to the reference's ``make_eval_step``'s."""
    jc, tc, replica, widened, tokens = _world()
    jp = jax.tree_util.tree_map(jnp.asarray, widened)
    want = j_step.make_eval_step(jc)(jp, {"tokens": jnp.asarray(tokens)})
    got = t_step.make_eval_step(tc, serve_runtime())(
        replica, {"tokens": torch.from_numpy(tokens)})
    assert float(got["accuracy"]) == float(want["accuracy"])
