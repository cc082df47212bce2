"""The port's training half against the JAX reference: the token pipeline,
the schedules, clipping, AdamW and SGD, the train and eval steps, the
checkpoints, and the launcher.

Same inputs on both sides, drawn with numpy from a seed (weights from the
JAX genesis through ``weights.params_from_numpy``).  Tolerances and their
reasons:

* token windows: equal -- the same numpy RNG calls;
* schedules: 2e-7 relative or one unit in the last place of ``lr`` --
  XLA's float32 ``cos`` and ``pow`` are other implementations than
  torch's, a unit apart, and ``1 + cos`` near the end of a cosine cancels;
* clipping: 1e-6 -- float32 sums of squares in another order;
* optimizer updates against the jitted reference (its fused multiply-adds
  and its divisions): bit for bit at a constant learning rate, with
  float32 and with bfloat16 moments; 1e-6 through the warm-up cosine
  schedule, whose float32 ``cos`` is another implementation than torch's,
  and there bfloat16 moments one bfloat16 unit apart where the float32
  value before the cast sits on a rounding boundary;
* three train steps of reduced internlm2 in float32 (microbatches 1, 2
  and 3), and of the reduced MoE configs (microbatches 1 and 3):
  loss and ``grad_norm`` within 1e-5, parameters within 1e-5 (internlm2)
  and 3e-5 (MoE) -- gradients summed in another order (the reference's
  chunked cross-entropy), through AdamW's division by ``sqrt(v) + eps``:
  where a gradient entry is of the order of eps (1e-8), its float32 noise
  moves the update by lr times noise over eps (llama4's dense ``wdown``,
  a first gradient of 1.3e-8: 1.06e-5 after 3 steps); ``moe_aux`` within
  1e-5 relative; the signature within one flag per bucket;
* checkpoints: bit for bit, both ways.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.data.pipeline import TokenPipeline as JPipeline  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.runtime import Runtime as JRuntime  # noqa: E402
from repro.train import checkpoint as jck  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.aggregate import tree_leaves, tree_map  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.runtime import Runtime  # noqa: E402
from repro_torch.train import checkpoint as tck  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402
from test_torch_baselines import few_torch_threads  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent


def _configs(arch="internlm2-1.8b"):
    jc = dataclasses.replace(j_reduced(j_get_config(arch), d_model=64),
                             vocab_size=128)
    tc = dataclasses.replace(reduced(get_config(arch), d_model=64),
                             vocab_size=128)
    return jc, tc


def _np_params(jc, seed=0):
    return jax.tree_util.tree_map(
        np.array, j_tfm.init_params(jax.random.PRNGKey(seed), jc))


def _tree(seed, scale=1.0):
    """A small tree of float32 leaves, as numpy."""
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((5, 7)) * scale).astype(np.float32),
            "b": [(rng.standard_normal(11) * scale).astype(np.float32),
                  (rng.standard_normal((3, 2, 4)) * scale).astype(np.float32)]}


def _np(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _tnp(tree):
    return [a.detach().float().numpy() for a in tree_leaves(tree)]


# -- token pipeline ---------------------------------------------------------


@pytest.mark.parametrize("seed,n_shards,shard", [(0, 1, 0), (3, 3, 2),
                                                 (5, 4, 1)])
def test_token_pipeline_windows_match_reference(seed, n_shards, shard):
    kw = dict(vocab=64, batch=4, seq=33, n_tokens=4001, seed=seed,
              n_shards=n_shards, shard=shard)
    ref, got = JPipeline(**kw), TokenPipeline(**kw)
    assert np.array_equal(got.stream, ref.stream)
    for a, b in zip((next(iter(ref)) for _ in range(3)),
                    (next(iter(got)) for _ in range(3))):
        assert np.array_equal(a, b)
    for k, v in got.batch_dict(a).items():
        assert np.array_equal(v, ref.batch_dict(a)[k]) and v.dtype == np.int32


def test_token_pipeline_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match="out of range"):
        TokenPipeline(vocab=16, batch=2, seq=8, n_tokens=100, n_shards=2,
                      shard=2)
    with pytest.raises(ValueError, match="need at least"):
        TokenPipeline(vocab=16, batch=2, seq=80, n_tokens=100, n_shards=2)


# -- schedules, clipping, optimizers ----------------------------------------


@pytest.mark.parametrize("name", ["constant", "cosine", "warmup_cosine"])
def test_schedules_match_reference(name):
    args = {"constant": (3e-4,), "cosine": (3e-4, 200, 0.1),
            "warmup_cosine": (3e-4, 20, 200, 0.05)}[name]
    ref = getattr(jopt, f"{name}_schedule" if name != "warmup_cosine"
                  else name)(*args)
    got = getattr(topt, f"{name}_schedule" if name != "warmup_cosine"
                  else name)(*args)
    steps = np.arange(0, 260, dtype=np.int32)
    want = np.asarray([ref(jnp.int32(s)) for s in steps], np.float32)
    have = np.asarray([got(int(s)) for s in steps], np.float32)
    ulp = float(np.spacing(np.float32(args[0])))
    np.testing.assert_allclose(have, want, rtol=2e-7, atol=ulp)


@pytest.mark.parametrize("scale", [0.01, 1.0])
def test_clip_by_global_norm_matches_reference(scale):
    grads = _tree(1, scale)
    want, want_norm = jopt.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, grads), 1.0)
    got, got_norm = topt.clip_by_global_norm(params_from_numpy(grads, "cpu"),
                                             1.0)
    assert (float(want_norm) > 1.0) == (scale == 1.0)
    assert got_norm.dtype == torch.float32
    np.testing.assert_allclose(float(got_norm), float(want_norm), rtol=1e-6)
    for a, b in zip(_tnp(got), _np(want)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def _reference_step(opt):
    """The reference's update and ``apply_updates`` as one program, which
    the caller jits, as its training loops run them (``fl/backend.py``,
    the cohort programs, ``launch/train.py``)."""
    def step(p, g, s):
        u, s = opt.update(g, s, p)
        return jopt.apply_updates(p, u), s
    return step


def _run_optimizer(make_ref, make_got, steps=4, params=None, grads=None):
    params = _tree(2) if params is None else params
    grads = grads or (lambda i: _tree(10 + i, 0.5))
    ref_opt, got_opt = make_ref(), make_got()
    ref_step = jax.jit(_reference_step(ref_opt))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = params_from_numpy(params, "cpu")
    js, ts = ref_opt.init(jp), got_opt.init(tp)
    for i in range(steps):
        g = grads(i)
        jp, js = ref_step(jp, jax.tree_util.tree_map(jnp.asarray, g), js)
        tu, ts = got_opt.update(params_from_numpy(g, "cpu"), ts, tp)
        topt.apply_updates(tp, tu)
    assert ts["step"] == int(js["step"]) == steps
    return jp, js, tp, ts


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_matches_reference(moments):
    kw = dict(lr=jopt.warmup_cosine(1e-2, 2, 10), b1=0.9, b2=0.95,
              weight_decay=0.1)
    jp, js, tp, ts = _run_optimizer(
        lambda: jopt.adamw(moment_dtype=getattr(jnp, moments), **kw),
        lambda: topt.adamw(moment_dtype=getattr(torch, moments),
                           **dict(kw, lr=topt.warmup_cosine(1e-2, 2, 10))))
    for a, b in zip(_tnp(tp), _np(jp)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    for key in ("m", "v"):
        for a, b in zip(tree_leaves(ts[key]), jax.tree_util.tree_leaves(
                js[key])):
            assert str(a.dtype).endswith(moments)
            b = np.asarray(b.astype(jnp.float32))
            if moments == "float32":
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                           atol=1e-9)
            else:
                np.testing.assert_allclose(a.float().numpy(), b,
                                           rtol=2 ** -7, atol=1e-12)


@pytest.mark.parametrize("momentum,weight_decay", [(0.0, 0.0), (0.9, 0.0),
                                                   (0.9, 0.01)])
def test_sgd_matches_reference(momentum, weight_decay):
    jp, _, tp, _ = _run_optimizer(
        lambda: jopt.sgd(0.05, momentum, weight_decay),
        lambda: topt.sgd(0.05, momentum, weight_decay))
    for a, b in zip(_tnp(tp), _np(jp)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def _normals(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(4096) * scale).astype(np.float32)


@pytest.mark.parametrize("momentum,weight_decay", [(0.0, 0.0), (0.0, 0.01),
                                                   (0.9, 0.0), (0.9, 0.01)])
def test_sgd_equals_jitted_reference_bits(momentum, weight_decay):
    """4,096 float32 parameters over 4 steps, bit for bit: each ``a*b + c``
    of the jitted update is one fused multiply-add."""
    jp, js, tp, ts = _run_optimizer(
        lambda: jopt.sgd(0.05, momentum, weight_decay),
        lambda: topt.sgd(0.05, momentum, weight_decay),
        params=_normals(0), grads=lambda i: _normals(10 + i, 0.5))
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    if momentum:
        assert np.array_equal(ts["mu"].numpy(), np.asarray(js["mu"]))


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_equals_jitted_reference_bits(moments, weight_decay):
    """4,096 float32 parameters over 4 AdamW steps, bit for bit: the
    moments, ``m / (bc1 * (sqrt(v / bc2) + eps))`` as XLA rewrites it, and
    the fused products (with bfloat16 moments the update's own fusion
    takes the other product of each moment)."""
    jp, js, tp, ts = _run_optimizer(
        lambda: jopt.adamw(1e-2, weight_decay=weight_decay,
                           moment_dtype=getattr(jnp, moments)),
        lambda: topt.adamw(1e-2, weight_decay=weight_decay,
                           moment_dtype=getattr(torch, moments)),
        params=_normals(0), grads=lambda i: _normals(10 + i, 0.5))
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    for key in ("m", "v"):
        assert np.array_equal(ts[key].float().numpy(),
                              np.asarray(js[key].astype(jnp.float32)))


def test_adamw_bfloat16_moments_equal_jitted_reference_bits():
    """The stored bfloat16 moments are the float32 ``fma(g, 1 - b, m * b)``
    rounded once, as XLA:CPU contracts the moments of a bfloat16-moment
    program: on leaves of 4,096 and 6,000 parameters over 4 steps, every
    stored ``m`` and ``v`` and every parameter bit for bit (the other
    product, ``fma(m, b1, (1 - b1) * g)``, put ``m`` of ``b`` at index
    5,374 one bfloat16 unit off after step 4)."""
    def tree(seed, scale=1.0):
        r = np.random.default_rng(seed)
        return {"a": (r.standard_normal(4096) * scale).astype(np.float32),
                "b": (r.standard_normal(6000) * scale).astype(np.float32)}

    jp, js, tp, ts = _run_optimizer(
        lambda: jopt.adamw(1e-2, weight_decay=0.1, moment_dtype=jnp.bfloat16),
        lambda: topt.adamw(1e-2, weight_decay=0.1,
                           moment_dtype=torch.bfloat16),
        params=tree(5), grads=lambda i: tree(10 + i, 0.5))
    for a, b in zip(_tnp(tp), _np(jp)):
        assert np.array_equal(a, b)
    for key in ("m", "v"):
        for leaf in ("a", "b"):
            got, want = ts[key][leaf], js[key][leaf]
            assert got.dtype == torch.bfloat16
            assert np.array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_in_pieces_equals_one_piece(monkeypatch, moments):
    """A leaf larger than ``_PIECE`` elements (an MoE layer's experts at
    full width) is updated in pieces: pieces of 1,000 over leaves of 4,096
    and (3, 40, 50) elements, the last piece ragged, give the parameters
    and moments of one piece bit for bit, and the parameters of the
    jitted reference."""
    def tree(seed, scale=1.0):
        r = np.random.default_rng(seed)
        return {"a": (r.standard_normal(4096) * scale).astype(np.float32),
                "b": (r.standard_normal((3, 40, 50)) * scale)
                .astype(np.float32)}

    runs = []
    for piece in (topt._PIECE, 1000):
        monkeypatch.setattr(topt, "_PIECE", piece)
        runs.append(_run_optimizer(
            lambda: jopt.adamw(1e-2, weight_decay=0.1,
                               moment_dtype=getattr(jnp, moments)),
            lambda: topt.adamw(1e-2, weight_decay=0.1,
                               moment_dtype=getattr(torch, moments)),
            params=tree(5), grads=lambda i: tree(10 + i, 0.5)))
    (jp, _, whole, whole_state), (_, _, pieces, piece_state) = runs
    for a, b, c in zip(_tnp(pieces), _tnp(whole), _np(jp)):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    for key in ("m", "v"):
        for a, b in zip(tree_leaves(piece_state[key]),
                        tree_leaves(whole_state[key])):
            assert torch.equal(a, b)


# -- train and eval steps ---------------------------------------------------


@pytest.mark.parametrize("microbatches", [1, 2, 3])
def test_train_step_matches_reference(microbatches):
    """Three AdamW steps of reduced internlm2 (float32) with clipping and
    the signature in the metrics, on the same pipeline batches (6 rows at
    3 microbatches, where the mean's reciprocal is inexact)."""
    _train_steps_agree(*_configs(), microbatches, atol=1e-5)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b",
                                  "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("microbatches", [1, 3])
def test_moe_train_step_matches_reference(arch, microbatches):
    """The same steps over the reduced MoE configs: ``moe_aux`` nonzero,
    its mean over microbatches by the float32 reciprocal."""
    _train_steps_agree(*_configs(arch), microbatches, atol=3e-5)


def _train_steps_agree(jc, tc, microbatches, atol):
    np_params = _np_params(jc)
    ref_step, ref_opt = jstep.make_train_step(
        jc, runtime=JRuntime(want_signature=True), clip_norm=1.0,
        microbatches=microbatches)
    got_step, got_opt = tstep.make_train_step(
        tc, runtime=Runtime(want_signature=True), clip_norm=1.0,
        microbatches=microbatches)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params, "cpu")
    js, ts = ref_opt.init(jp), got_opt.init(tp)
    ref_step = jax.jit(ref_step)
    batch_rows = 6 if microbatches == 3 else 4
    pipe = TokenPipeline(128, batch_rows, 32, n_tokens=5000, seed=1)
    it = iter(pipe)
    for _ in range(3):
        batch = pipe.batch_dict(next(it))
        jp, js, jm = ref_step(jp, js, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        tp, ts, tm = got_step(tp, ts, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
        for key in ("loss", "ce_loss", "grad_norm"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), abs=1e-5)
        if jc.moe is None:
            assert float(tm["moe_aux"]) == float(jm["moe_aux"]) == 0.0
        else:
            assert float(tm["moe_aux"]) > 0.0
            assert float(tm["moe_aux"]) == pytest.approx(
                float(jm["moe_aux"]), rel=1e-5)
        np.testing.assert_allclose(tm["signature"].numpy(),
                                   np.asarray(jm["signature"]), rtol=0,
                                   atol=1 / (batch_rows * 32) + 1e-7)
    assert float(tm["grad_norm"]) > 0.0
    for a, b in zip(_tnp(tp), _np(jp)):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def test_eval_step_matches_reference():
    jc, tc = _configs()
    np_params = _np_params(jc, seed=3)
    pipe = TokenPipeline(128, 4, 32, n_tokens=5000, seed=2)
    batch = pipe.batch_dict(next(iter(pipe)))
    want = jstep.make_eval_step(jc)(
        jax.tree_util.tree_map(jnp.asarray, np_params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = tstep.make_eval_step(tc)(params_from_numpy(np_params, "cpu"),
                                   {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    assert np.float32(got["accuracy"]) == np.float32(want["accuracy"])


def test_serving_steps_are_built():
    """The serving pair replaced its raises: a prefill and one decode step
    of the reduced internlm2, the step's token the argmax of its logits
    (held against the reference in ``test_torch_decode.py``)."""
    _, tc = _configs()
    params = params_from_numpy(_np_params(_configs()[0]), "cpu")
    prefill = tstep.make_serve_prefill(tc)
    decode = tstep.make_serve_decode(tc)
    tokens = torch.from_numpy(np.arange(10, dtype=np.int32).reshape(2, 5))
    logits, caches = prefill(params, {"tokens": tokens})
    assert logits.shape == (2, tc.vocab_size)
    from repro_torch.launch.serve import extend_caches
    caches = extend_caches(caches, tc, 1)
    tok, step_logits, _ = decode(params, logits.argmax(-1)[:, None], caches,
                                 5)
    assert torch.equal(tok, step_logits.argmax(-1).to(torch.int32))


# -- checkpoints ------------------------------------------------------------


def _state(moments):
    """Reduced-internlm2 parameters and an AdamW state after one update,
    in both packages, from the same numbers."""
    jc, _ = _configs()
    params = _np_params(jc, seed=4)
    opt = jopt.adamw(1e-3, moment_dtype=getattr(jnp, moments))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = opt.init(jp)
    _, js = opt.update(jax.tree_util.tree_map(lambda p: p * 0.5, jp), js, jp)
    tp = params_from_numpy(params, "cpu")
    ts = {"step": int(js["step"]),
          **{key: tree_map(lambda a: torch.from_numpy(np.array(
              a.astype(jnp.float32))).to(getattr(torch, moments)), js[key])
             for key in ("m", "v")}}
    return (jp, js), (tp, ts)


def _bits(t):
    t = t.detach()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_reference_checkpoint_loads_in_the_port(tmp_path, moments):
    (jp, js), (tp, ts) = _state(moments)
    tree = {"params": jp, "opt": js}
    jck.save_checkpoint(str(tmp_path / "ref.npz"), tree, step=7)
    like = tree_map(lambda t: torch.zeros_like(t) if isinstance(
        t, torch.Tensor) else 0, {"params": tp, "opt": ts})
    got, step = tck.load_checkpoint(str(tmp_path / "ref"), like)
    assert step == 7 and got["opt"]["step"] == 1
    want = tree_map(lambda t: t, {"params": tp, "opt": ts})
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(_bits(a), _bits(b))
        else:
            assert a == b


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    """float32 trees (the reference's own loader reads no bfloat16: numpy
    hands it raw two-byte words)."""
    (jp, js), (tp, ts) = _state("float32")
    tck.save_checkpoint(str(tmp_path / "port.npz"), {"params": tp, "opt": ts},
                        step=9)
    like = jax.tree_util.tree_map(jnp.zeros_like, {"params": jp, "opt": js})
    got, step = jck.load_checkpoint(str(tmp_path / "port"), like)
    assert step == 9
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves({"params": jp, "opt": js})):
        assert a.dtype == b.dtype
        assert np.array_equal(np.asarray(a), np.asarray(b))
    # the same keys, and the same bytes where the types agree
    ref = np.load(jck.save_checkpoint(str(tmp_path / "ref.npz"),
                                      {"params": jp, "opt": js}, step=9))
    port = np.load(str(tmp_path / "port.npz"))
    assert sorted(port.files) == sorted(ref.files)
    assert "stages/[0]/l0/core/wq" in [k[len("params/"):]
                                       for k in port.files]
    for k in ref.files:
        if k not in ("opt/step", "__step__"):
            assert port[k].tobytes() == ref[k].tobytes(), k


def test_port_checkpoint_round_trip_is_exact(tmp_path):
    _, (tp, ts) = _state("bfloat16")
    tree = {"params": tp, "opt": ts}
    tck.save_checkpoint(str(tmp_path / "a.npz"), tree, step=3)
    like = tree_map(lambda t: torch.zeros_like(t) if isinstance(
        t, torch.Tensor) else 0, tree)
    got, step = tck.load_checkpoint(str(tmp_path / "a.npz"), like)
    assert step == 3
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))
        else:
            assert a == b
    with pytest.raises(KeyError, match="missing"):
        tck.load_checkpoint(str(tmp_path / "a.npz"),
                            dict(like, extra=torch.zeros(2)))


# -- the launcher -----------------------------------------------------------


@pytest.mark.parametrize("extra", [["--steps", "2"],
                                   ["--dagafl", "2", "--rounds", "1",
                                    "--local-steps", "2"]])
def test_launcher_runs_on_the_cpu(tmp_path, extra):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="2")
    ckpt = ["--checkpoint", str(tmp_path / "ck")] if "--steps" in extra \
        else []
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--seq", "32", "--batch", "4"] + extra + ckpt,
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "arch=internlm2-1.8b-smoke" in out.stdout
    if ckpt:
        assert "step     1 loss=" in out.stdout
        assert (tmp_path / "ck.npz").exists()
    else:
        assert "'chain_len': 3" in out.stdout
    assert "jax" not in out.stderr.lower()


def test_launcher_flags_replace_the_kernel_policy():
    from repro_torch.launch.train import parser
    args = parser().parse_args(["--device", "cpu"])
    assert args.device == "cpu" and not hasattr(args, "kernel_policy")
    with pytest.raises(SystemExit):
        parser().parse_args(["--kernel-policy", "auto"])
