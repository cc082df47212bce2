"""Dry run: every (arch x input shape) on the production mesh, counted
without allocating (port of ``repro.launch.dryrun``).

The reference lowers and compiles each step for 256 or 512 forced host
devices, partitions it with the sharding rules and reads the partitioned
HLO.  The port counts the same sharded step in eager PyTorch, on the CPU:

  * the mesh is a DTensor ``DeviceMesh`` of the production mesh's axes and
    shape over a fake process group (``launch.mesh.dtensor_mesh``): this
    process is chip 0, and no collective moves data;
  * the parameters, optimizer state, batch and caches are built
    shape-only under ``FakeTensorMode`` (the counterpart of
    ``jax.eval_shape``) and placed as DTensors by the sharding rules
    (``sharding.rules.dtensor_placements``), the reference's
    ``in_shardings``; the runtime carries the mesh (``Runtime.dmesh``) and
    the batch axes, so the models take their DTensor paths
    (``sharding.dtensor``: the batch constraint, the chip-by-chip regions
    for the scans, the attention scores, the experts and the sLSTM's
    ``shard_map`` counterpart), and a training step places its gradient,
    new parameters and state back at their shardings, the reference's
    ``out_shardings``;
  * the step runs once under a :class:`~repro_torch.launch.cost_analysis.
    CostCount`, which sees chip 0's local operations and collectives and
    applies the reference's cost model to them, its Mamba and sLSTM step
    loops folded (``launch.cost_analysis.folded``).

:func:`build_step` also runs the step with values: given the caller's
tensors and a mesh of ``launch.mesh.run_on_chips``, whose collectives
move data, each chip copies its blocks out of them and computes its own.

Per chip, then: FLOPs and cost-model bytes of the local program;
collective bytes by the reference's kinds; argument bytes from the
sharding rules; the peak of the bytes the step's own storages hold
(``peak_bytes_per_chip``) and ``hbm_gib_per_chip``, argument plus peak
bytes, with ``fits_hbm`` comparing it to 80 GB; and the three-term
roofline on the NVIDIA H100 SXM's published peaks (``launch.mesh``: bf16
FLOP/s, HBM and NVLink bytes/s), a bound from a CPU count, not a card
time.

What differs from XLA's partitioner: DTensor picks its own
redistributions (an all-reduce or a reduce-scatter where XLA may pick
the other, a gather where XLA may all-to-all), and the regions follow
XLA's plans only where written out.  The peak is eager liveness, freed
as references drop, not XLA's buffer assignment: on the reduced 4 x 2
cases it reads 0.25 to 7.2 times XLA's ``temp_size_in_bytes``, so
``fits_hbm`` is an estimate, not a verdict.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch xlstm-125m \\
        --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

``--all`` counts the records in a pool of processes, one a CPU core.
Records go to ``experiments/dryrun/<arch>__<shape>[__multipod][__opt].json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.launch.cost_analysis import CostCount
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, NVLINK_BW,
                                     PEAK_FLOPS_BF16, dtensor_mesh,
                                     make_production_mesh)
from repro_torch.models import transformer as tfm
from repro_torch.runtime import Runtime
from repro_torch.sharding.rules import (MeshPlan, batch_shardings,
                                        cache_shardings, dtensor_placements,
                                        leaves_with_path, map_with_path,
                                        opt_state_shardings, param_shardings,
                                        small_model_plan)
from repro_torch.train.step import (make_serve_decode, make_serve_prefill,
                                    make_train_step)

def input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """Shape-only stand-ins for every model input (call under
    ``FakeTensorMode``); decode's ``pos`` is a Python int, the cache's last
    slot, so the step attends over the whole cache as the reference's
    traced position does."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.mode == "train":
        batch = {"tokens": torch.empty((B, S), dtype=i32),
                 "labels": torch.empty((B, S), dtype=i32)}
    elif shape.mode == "prefill":
        batch = {"tokens": torch.empty((B, S), dtype=i32)}
    else:  # decode
        batch = {"token": torch.empty((B, 1), dtype=i32), "pos": S - 1}
    if cfg.encoder is not None and shape.mode in ("train", "prefill"):
        batch["enc_embed"] = torch.empty((B, cfg.encoder.n_ctx, cfg.d_model))
    if cfg.mrope_sections is not None and shape.mode in ("train", "prefill"):
        batch["positions"] = torch.empty((3, B, S), dtype=i32)
    return batch


def model_flops(cfg: ArchConfig, shape: InputShape) -> float:
    """Useful-FLOPs yardstick: 6·N_active·tokens (train), 2·N_active·tokens
    (forward only)."""
    n = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.mode != "decode"
                                   else 1)
    mult = 6.0 if shape.mode == "train" else 2.0
    return mult * n * tokens


def make_plan(cfg: ArchConfig, multi_pod: bool, plan_mode: str = "baseline",
              shape=None) -> MeshPlan:
    """The reference's plans: ``baseline``, or ``auto`` (small archs pure
    data parallel when the batch divides, giant-arch training with 4
    microbatches, decode without FSDP and with 2-D expert and table
    sharding)."""
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    n_batch_chips = 256 if not multi_pod else 512
    if plan_mode == "auto":
        if cfg.param_count() < 3e9 and shape is not None \
                and shape.global_batch % n_batch_chips == 0:
            return small_model_plan(batch_axes, "model", cfg.param_count())
        if shape is not None and shape.mode == "train" \
                and cfg.param_count() > 1e11:
            plan = MeshPlan(batch_axes=batch_axes)
            object.__setattr__(plan, "_microbatches", 4)
            return plan
        if shape is not None and shape.mode == "decode":
            return MeshPlan(batch_axes=batch_axes, enable_fsdp=False,
                            expert_data_shard=cfg.moe is not None,
                            dense_2d_shard=True)
    return MeshPlan(batch_axes=batch_axes)


def place(tree, shardings, dmesh):
    """``tree`` with each tensor leaf a DTensor on ``dmesh`` holding its
    block under its sharding (``sharding.rules.dtensor_placements``),
    split locally (no collective).  Each block is a copy on the chip's
    device: no two chips share storage, and none shares the caller's, so
    an in-place update on one chip (the optimizer's) changes its block
    alone."""
    sh = dict(leaves_with_path(shardings))
    device = torch.device(dmesh.device_type)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())

    def put(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        placements = dtensor_placements(sh[path].spec, dmesh)
        block = distribute_tensor(leaf, dmesh, placements,
                                  src_data_rank=None).to_local()
        return DTensor.from_local(block.to(device, copy=True), dmesh,
                                  placements, run_check=False,
                                  shape=leaf.shape, stride=leaf.stride())
    return map_with_path(put, tree)


def build_step(cfg: ArchConfig, shape: InputShape, mesh, plan: MeshPlan,
               dmesh=None, *, params=None, opt_state=None, batch=None,
               caches=None, use_kernels: bool = False):
    """(step, its arguments' shardings, the arguments), the step a
    closure over its arguments.

    The arguments are the caller's where given: ``params``, the training
    step's ``opt_state`` (default: the optimizer's fresh state),
    ``batch`` (as :func:`input_specs` makes it: decode's ``{"token",
    "pos"}``, ``pos`` a Python int) and decode's ``caches`` (default:
    zeros).  Without them the step is the count's, over shape-only
    arguments: call it under ``FakeTensorMode``.  ``use_kernels`` has the
    serving steps launch the kernels, as ``runtime.serve_runtime``.

    With ``dmesh`` (``launch.mesh.dtensor_mesh(mesh)`` for a count,
    ``launch.mesh.run_on_chips`` for values) the arguments are DTensors
    placed by the sharding rules (:func:`place`), the runtime carries the
    mesh and the batch axes, as the reference's ``in_shardings`` and
    ``Runtime``, and the training step places its new parameters and
    state back at their shardings (``train.step``); the step returns
    DTensors (``full_tensor()`` gathers one).  Without it, the unsharded
    step on the arguments' device."""
    if params is None:
        params = tfm.init_params(torch.Generator(), cfg)
    params_sh = param_shardings(params, cfg, mesh, plan)
    batch = input_specs(cfg, shape) if batch is None else batch
    runtime = Runtime(want_signature=shape.mode == "train",
                      use_kernels=use_kernels and shape.mode != "train")
    if dmesh is not None:
        runtime = dataclasses.replace(
            runtime, batch_axes=tuple(plan.batch_axes), dmesh=dmesh,
            batch_axis_size=plan.axis_size(mesh, tuple(plan.batch_axes)))

    def placed(trees, shardings):
        if dmesh is None:
            return trees
        # serving runs under inference mode, where a DTensor made outside
        # it cannot be viewed
        with torch.inference_mode(shape.mode != "train"):
            return [place(t, sh, dmesh) for t, sh in zip(trees, shardings)]

    def sharded(fn):
        """``fn`` where a plain tensor the step makes (a position table,
        a zero state, a mask) meets a DTensor as a replicated one."""
        if dmesh is None:
            return fn

        def run(*a, **kw):
            with implicit_replication():
                return fn(*a, **kw)
        return run

    if shape.mode == "train":
        step, opt = make_train_step(
            cfg, runtime=runtime,
            microbatches=getattr(plan, "_microbatches", 0) or 1)
        if opt_state is None:
            opt_state = opt.init(params)
        shardings = [params_sh, opt_state_shardings(opt_state, params_sh,
                                                    mesh),
                     batch_shardings(batch, mesh, plan)]
        args = placed([params, opt_state, batch], shardings)
        return sharded(lambda: step(*args)), shardings, args
    if shape.mode == "prefill":
        fn = make_serve_prefill(cfg, runtime)
        shardings = [params_sh, batch_shardings(batch, mesh, plan)]
        args = placed([params, batch], shardings)
        return sharded(lambda: fn(*args)), shardings, args
    fn = make_serve_decode(cfg, runtime)
    if caches is None:
        caches = tfm.init_cache(cfg, shape.global_batch, shape.seq_len)
    token = {"tokens": batch["token"]}
    shardings = [params_sh, batch_shardings(token, mesh, plan),
                 cache_shardings(caches, cfg, mesh, plan)]
    args = placed([params, token, caches], shardings)

    def decode(token=None, pos=None):
        """One decode step on the placed caches; a later step takes its
        token (placed as ``shardings[1]["tokens"]``) and position."""
        return fn(args[0], args[1]["tokens"] if token is None else token,
                  args[2], batch["pos"] if pos is None else pos)
    return sharded(decode), shardings, args


def argument_bytes_per_chip(shardings, trees) -> int:
    """Bytes of one device's blocks of every argument leaf."""
    total = 0
    for sh_tree, tree in zip(shardings, trees):
        sh = dict(leaves_with_path(sh_tree))
        for path, leaf in leaves_with_path(tree):
            if isinstance(leaf, torch.Tensor) and path in sh:
                total += sh[path].shard_bytes(leaf)
    return total


def run_one(arch: str, shape_name: str, multi_pod: bool = False,
            out_dir: str = "experiments/dryrun", verbose: bool = True,
            plan_mode: str = "baseline", tag_suffix: str = "") -> dict:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if plan_mode == "auto" and shape.mode == "decode":
        # serving weights in bf16
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    if plan_mode == "auto" and shape.mode == "train" \
            and cfg.param_count() > 1e11:
        # giant-arch training: bf16 parameters and moments
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16",
                                  moment_dtype="bfloat16")
    n = 512 if multi_pod else 256
    mesh = make_production_mesh(multi_pod=multi_pod,
                                devices=[torch.device("meta")] * n)
    n_chips = mesh.size
    plan = make_plan(cfg, multi_pod, plan_mode, shape)

    t0 = time.time()
    record = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
              "mesh": dict(mesh.shape), "n_chips": n_chips, "ok": False,
              "plan": plan_mode}
    try:
        with dtensor_mesh(mesh) as dmesh, \
                FakeTensorMode(allow_non_fake_inputs=True):
            step, shardings, args = build_step(cfg, shape, mesh, plan, dmesh)
            t_build = time.time() - t0
            with CostCount() as cost:
                step()
        t_count = time.time() - t0 - t_build
        args_b = argument_bytes_per_chip(shardings, args)
        mf = model_flops(cfg, shape)
        terms = {"compute_s": cost.flops / PEAK_FLOPS_BF16,
                 "memory_s": cost.bytes / HBM_BW,
                 "collective_s": cost.collective_bytes / NVLINK_BW}
        dominant = max(terms, key=terms.get)
        hbm = args_b + cost.peak_bytes
        record.update({
            "ok": True,
            "build_s": round(t_build, 2), "count_s": round(t_count, 2),
            "flops_per_chip": cost.flops,
            "bytes_per_chip": cost.bytes,
            "collective_bytes_per_chip": cost.collective_bytes,
            "collectives": {k: float(v) for k, v in cost.colls.items()},
            "argument_bytes_per_chip": args_b,
            "argument_gib_per_chip": args_b / 2 ** 30,
            "peak_bytes_per_chip": cost.peak_bytes,
            "hbm_gib_per_chip": hbm / 2 ** 30,
            "fits_hbm": hbm <= HBM_BYTES,
            "model_flops_global": mf,
            "model_flops_per_chip": mf / n_chips,
            "useful_flop_ratio": ((mf / n_chips) / cost.flops
                                  if cost.flops else None),
            "roofline": terms,
            "dominant": dominant,
            "step_time_bound_s": max(terms.values()),
            "ops_counted": sum(cost.ops.values()),
            "hardware": "NVIDIA H100 SXM published peaks: "
                        f"{PEAK_FLOPS_BF16:.3g} FLOP/s bf16, "
                        f"{HBM_BW:.3g} B/s HBM, {NVLINK_BW:.3g} B/s NVLink, "
                        f"{HBM_BYTES:.3g} B HBM",
            "counted": "chip 0's local program on DTensors over a fake "
                       "process group, on the CPU; not a card time",
        })
        if verbose:
            print(f"[{arch} x {shape_name}"
                  f"{' x multipod' if multi_pod else ''}] OK "
                  f"build={t_build:.1f}s count={t_count:.1f}s")
            print(f"  args/chip={args_b / 2 ** 30:.2f}GiB "
                  f"peak/chip={cost.peak_bytes / 2 ** 30:.2f}GiB "
                  f"flops/chip={cost.flops:.3e} bytes/chip={cost.bytes:.3e} "
                  f"coll/chip={cost.collective_bytes:.3e}")
            print(f"  terms: compute={terms['compute_s'] * 1e3:.2f}ms "
                  f"memory={terms['memory_s'] * 1e3:.2f}ms "
                  f"coll={terms['collective_s'] * 1e3:.2f}ms -> {dominant} "
                  f"dominates; useful-flop ratio="
                  f"{record['useful_flop_ratio']}")
    except Exception as e:  # noqa: BLE001
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[{arch} x {shape_name}] FAILED: {record['error']}")

    os.makedirs(out_dir, exist_ok=True)
    tag = (f"{arch}__{shape_name}" + ("__multipod" if multi_pod else "")
           + tag_suffix)
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(record, f, indent=2, default=str)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS) + [None])
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) baseline")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--plan", default="baseline",
                    choices=["baseline", "auto"],
                    help="auto = the reference's beyond-baseline plans")
    args = ap.parse_args(argv)
    suffix = "__opt" if args.plan == "auto" else ""
    if args.all:
        jobs = [(arch, shape, args.multi_pod, args.out, True, args.plan,
                 suffix) for arch in ARCH_IDS for shape in INPUT_SHAPES]
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(min(os.cpu_count() or 1, len(jobs)),
                                 mp_context=ctx) as pool:
            results = list(pool.map(run_one, *zip(*jobs)))
        ok = sum(r["ok"] for r in results)
        print(f"\n{ok}/{len(results)} combinations counted")
        raise SystemExit(0 if ok == len(results) else 1)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    rec = run_one(args.arch, args.shape, args.multi_pod, args.out,
                  plan_mode=args.plan, tag_suffix=suffix)
    raise SystemExit(0 if rec["ok"] else 1)


if __name__ == "__main__":
    main()
