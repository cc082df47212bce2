"""The dry run's cost count (``launch.cost_analysis``) and records
(``launch.dryrun``) against the reference's.

Exact counts first: a matrix product is 2mnk, a Python loop counts each
step, a composite product under inference mode counts its parts, a cache
update counts its bytes twice.  Then the count of
``tests/test_dryrun_small.py``'s four reduced cases against the
reference's ``analyze_hlo`` of the same step on one device, which the
reference computes in a subprocess (its dry-run module sets ``XLA_FLAGS``
when imported; jax locks the device count at first use):

* prefill (whisper-medium) and decode (deepseek-v2-236b): FLOPs within 5%
  (measured: equal);
* training: both rematerialise every period (``Runtime.remat``, on by
  default), so each backward recomputes the periods' forward: the port's
  default count within 5% of the reference's, and its ``remat=False``
  count within 5% of the reference's ``remat=False`` count.

The plans, the useful-FLOPs yardstick and the input stand-ins equal the
reference's for every arch and shape, and ``run_one`` writes the record's
keys.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config, reduced  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.cost_analysis import CostCount  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime import Runtime  # noqa: E402
from repro_torch.sharding.rules import MeshPlan  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")
CASES = [("internlm2-1.8b", "train", 8, 64),
         ("jamba-v0.1-52b", "train", 8, 64),
         ("deepseek-v2-236b", "decode", 8, 128),
         ("whisper-medium", "prefill", 8, 64)]

_REFERENCE = r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, sys
import numpy as np
import jax
from jax.sharding import Mesh
sys.path.insert(0, "src")
from repro.configs import ARCH_IDS, INPUT_SHAPES, get_config, reduced
from repro.configs.base import InputShape
from repro.launch import dryrun
from repro.launch.hlo_analysis import analyze_hlo
from repro.models import transformer as tfm
from repro.runtime import Runtime
from repro.sharding.rules import MeshPlan
from repro.train.step import make_train_step

out = {"cases": {}, "plans": {}, "model_flops": {}, "specs": {}}
mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
for arch, mode, batch, seq in CASES:
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              compute_dtype="bfloat16",
                              cache_dtype="bfloat16")
    shape = InputShape("test", seq, batch, mode)
    jitted, args = dryrun.build_step(cfg, shape, mesh, MeshPlan())
    with mesh:
        cost = analyze_hlo(jitted.lower(*args).compile().as_text())
    res = {"flops": cost.flops, "bytes": cost.bytes}
    if mode == "train":
        params = jax.eval_shape(lambda k: tfm.init_params(k, cfg),
                                jax.random.PRNGKey(0))
        step, opt = make_train_step(cfg, runtime=Runtime(
            want_signature=True, remat=False))
        no_remat = analyze_hlo(jax.jit(step).lower(
            params, jax.eval_shape(opt.init, params),
            dryrun.input_specs(cfg, shape)).compile().as_text())
        res["flops_no_remat"] = no_remat.flops
    out["cases"][arch] = res
for arch in ARCH_IDS:
    cfg = get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        key = arch + "|" + name
        out["model_flops"][key] = dryrun.model_flops(cfg, shape)
        out["specs"][key] = {k: [list(v.shape), str(v.dtype)] for k, v in
                             dryrun.input_specs(cfg, shape).items()}
        for multi in (False, True):
            for mode in ("baseline", "auto"):
                p = dryrun.make_plan(cfg, multi, mode, shape)
                out["plans"][f"{key}|{multi}|{mode}"] = [
                    list(p.batch_axes), p.enable_fsdp, p.enable_tp,
                    p.attn_tp, p.expert_data_shard, p.dense_2d_shard,
                    getattr(p, "_microbatches", 0),
                    list(getattr(p, "_fsdp_axes", ()) or ())]
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def ref():
    script = f"CASES = {CASES!r}\n" + _REFERENCE
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=900)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def _count(fn):
    with FakeTensorMode():
        with CostCount() as cost:
            fn()
    return cost


@pytest.mark.parametrize("m,k,n", [(64, 128, 32), (1, 7, 5), (33, 1, 9)])
def test_matmul_is_2mnk(m, k, n):
    cost = _count(lambda: torch.empty(m, k) @ torch.empty(k, n))
    assert cost.flops == 2 * m * n * k
    assert cost.bytes == 4 * (m * k + k * n + m * n)
    batched = _count(lambda: torch.empty(3, 5, m, k) @ torch.empty(k, n))
    assert batched.flops == 2 * 15 * m * n * k
    addmm = _count(lambda: torch.addmm(torch.empty(n), torch.empty(m, k),
                                       torch.empty(k, n)))
    assert addmm.flops == 2 * m * n * k


@pytest.mark.parametrize("steps", [1, 3, 17])
def test_python_loop_counts_each_step(steps):
    def loop():
        h = torch.empty(4, 16)
        w = torch.empty(16, 16)
        for _ in range(steps):
            h = torch.tanh(h @ w)
    assert _count(loop).flops == steps * 2 * 4 * 16 * 16


def test_backward_counts_its_products():
    """The forward product, then the weight's and the input's gradient."""
    def step():
        x = torch.empty(5, 10, requires_grad=True)
        w = torch.empty(10, 64, requires_grad=True)
        (x @ w).sum().backward()
    assert _count(step).flops == 3 * 2 * 5 * 10 * 64


def test_inference_mode_counts_composite_parts():
    """Under inference mode ``matmul`` and ``einsum`` reach the mode whole:
    the count decomposes them into their products."""
    def fwd():
        with torch.inference_mode():
            torch.empty(2, 3, 8) @ torch.empty(8, 4)
            torch.einsum("bij,bjk->bik", torch.empty(2, 3, 8),
                         torch.empty(2, 8, 5))
    assert _count(fwd).flops == 2 * 6 * 4 * 8 + 2 * 2 * 3 * 5 * 8


def test_convolution_and_its_backward():
    def step():
        x = torch.empty(2, 3, 8, 8, requires_grad=True)
        w = torch.empty(4, 3, 3, 3, requires_grad=True)
        torch.nn.functional.conv2d(x, w, padding=1).sum().backward()
    assert _count(step).flops == 3 * 2 * (2 * 4 * 8 * 8) * 27


def test_cache_update_counts_twice():
    """A write into a slice of a buffer reads and writes it: twice its
    bytes (beside the slice's own select).  A whole-tensor copy is none."""
    def update():
        cache = torch.zeros(2, 100, 16)
        cache[:, 5] = torch.ones(2, 16)
    def whole():
        torch.zeros(2, 16).copy_(torch.ones(2, 16))
    assert _count(update).bytes == 3 * 2 * 16 * 4
    assert _count(whole).bytes == 0


@pytest.mark.parametrize("arch,mode,batch,seq", CASES)
def test_count_matches_reference_hlo_analysis(ref, record_property, arch,
                                              mode, batch, seq):
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              compute_dtype="bfloat16",
                              cache_dtype="bfloat16")
    mesh = make_host_mesh(4, 2, devices=[torch.device("meta")] * 8)
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, _, _ = dryrun.build_step(
            cfg, InputShape("test", seq, batch, mode), mesh, MeshPlan())
        with CostCount() as cost:
            step()
    want = ref["cases"][arch]
    assert cost.flops > 0 and cost.bytes > 0
    record_property("flops_ratio", cost.flops / want["flops"])
    assert cost.flops == pytest.approx(want["flops"], rel=0.05)
    if mode == "train":
        # the reference's subprocess builds this step as its own does
        with FakeTensorMode(allow_non_fake_inputs=True):
            params = tfm.init_params(torch.Generator(), cfg)
            step, opt = make_train_step(cfg, runtime=Runtime(
                want_signature=True, remat=False))
            opt_state = opt.init(params)
            inputs = dryrun.input_specs(cfg, InputShape("test", seq, batch,
                                                        mode))
            with CostCount() as no_remat:
                step(params, opt_state, inputs)
        assert no_remat.flops < cost.flops
        record_property("flops_ratio_no_remat",
                        no_remat.flops / want["flops_no_remat"])
        assert no_remat.flops == pytest.approx(want["flops_no_remat"],
                                               rel=0.05)


def test_plans_specs_and_model_flops_equal_reference(ref):
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for name, shape in INPUT_SHAPES.items():
            key = arch + "|" + name
            assert dryrun.model_flops(cfg, shape) == pytest.approx(
                ref["model_flops"][key], rel=1e-12)
            with FakeTensorMode():
                specs = {k: [list(v.shape), str(v.dtype).replace(
                    "torch.", "")] for k, v in
                    dryrun.input_specs(cfg, shape).items()
                    if isinstance(v, torch.Tensor)}
            want = {k: v for k, v in ref["specs"][key].items()
                    if k != "pos"}
            assert specs == want, key
            for multi in (False, True):
                for mode in ("baseline", "auto"):
                    p = dryrun.make_plan(cfg, multi, mode, shape)
                    got = [list(p.batch_axes), p.enable_fsdp, p.enable_tp,
                           p.attn_tp, p.expert_data_shard, p.dense_2d_shard,
                           getattr(p, "_microbatches", 0),
                           list(getattr(p, "_fsdp_axes", ()) or ())]
                    assert got == ref["plans"][f"{key}|{multi}|{mode}"]


def test_run_one_writes_the_record(tmp_path):
    """A decode and a training record of the sharded count on the (16, 16)
    mesh: per-chip counts, collectives by kind (a training step's
    gradient reduction among them), the three-term roofline and the
    per-chip peak; no process group left behind."""
    records = {}
    for arch, shape in (("xlstm-125m", "decode_32k"),
                        ("internlm2-1.8b", "train_4k")):
        rec = dryrun.run_one(arch, shape, out_dir=str(tmp_path),
                             verbose=False)
        assert rec["ok"], rec.get("traceback")
        records[shape] = json.loads((tmp_path / f"{arch}__{shape}.json")
                                    .read_text())
        assert not torch.distributed.is_initialized()
    for on_disk in records.values():
        assert on_disk["ok"] and on_disk["n_chips"] == 256
        for key in ("arch", "shape", "multi_pod", "mesh", "n_chips", "plan",
                    "flops_per_chip", "bytes_per_chip",
                    "argument_bytes_per_chip", "model_flops_global",
                    "model_flops_per_chip", "useful_flop_ratio", "roofline",
                    "dominant", "step_time_bound_s",
                    "collective_bytes_per_chip", "collectives",
                    "peak_bytes_per_chip", "hbm_gib_per_chip", "count_s"):
            assert key in on_disk, key
        assert set(on_disk["roofline"]) == {"compute_s", "memory_s",
                                            "collective_s"}
        assert on_disk["dominant"] in on_disk["roofline"]
        assert on_disk["step_time_bound_s"] == max(
            on_disk["roofline"].values())
        assert on_disk["collective_bytes_per_chip"] == pytest.approx(
            sum(on_disk["collectives"].values()))
        assert set(on_disk["collectives"]) <= {
            "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "collective-permute"}
        assert on_disk["roofline"]["collective_s"] == pytest.approx(
            on_disk["collective_bytes_per_chip"] / dryrun.NVLINK_BW)
        assert on_disk["model_flops_per_chip"] == pytest.approx(
            on_disk["model_flops_global"] / 256)
        assert 0 < on_disk["argument_bytes_per_chip"] < 2 ** 31
        assert on_disk["peak_bytes_per_chip"] > 0
        assert on_disk["hbm_gib_per_chip"] == pytest.approx(
            (on_disk["argument_bytes_per_chip"]
             + on_disk["peak_bytes_per_chip"]) / 2 ** 30)
    train = records["train_4k"]
    assert train["collectives"]["all-reduce"] > 0
    assert 0 < train["flops_per_chip"] < train["model_flops_global"]


def test_main_needs_arch_and_shape():
    with pytest.raises(SystemExit):
        dryrun.main([])
