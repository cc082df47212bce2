"""Dry run: every (arch x input shape) on the production mesh, counted
without allocating (port of ``repro.launch.dryrun``).

The reference lowers and compiles each step for 256 or 512 forced host
devices and reads the compiled HLO.  Eager PyTorch has no partitioner, so
the port counts instead: the production mesh is built over ``meta``
devices, and the parameters, optimizer state, batch and caches are built
shape-only under ``FakeTensorMode`` (the counterpart of
``jax.eval_shape``).  The step itself (the train step, the serving prefill
or one decode step) runs once under ``FakeTensorMode`` and a
:class:`~repro_torch.launch.cost_analysis.CostCount`, which applies the
reference's cost model operation by operation; eager loops run, so trip
counts come for free.

Per chip, with these assumptions:
  * FLOPs and cost-model bytes are the global counts divided by the
    chips (the work spread evenly, no replicated compute);
  * argument bytes are exact: each parameter, optimizer-state, batch and
    cache leaf's block under the sharding rules (``sharding.rules``);
  * collective bytes have no counterpart without a partitioner: the
    record's ``collective_bytes_per_chip`` is null, with the reason;
  * the roofline terms use the NVIDIA H100 SXM's published peaks
    (``launch.mesh``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch xlstm-125m \\
        --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Eager loops run step by step, about 10^4 operations a token for Jamba's
Mamba scan in training, so its records take the longest; ``--all`` counts
the records in a pool of processes, one a CPU core.

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

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.launch.cost_analysis import CostCount
from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16,
                                     make_production_mesh)
from repro_torch.models import transformer as tfm
from repro_torch.runtime import Runtime
from repro_torch.sharding.rules import (MeshPlan, batch_shardings,
                                        cache_shardings, leaves_with_path,
                                        opt_state_shardings, param_shardings,
                                        small_model_plan)
from repro_torch.train.step import (make_serve_decode, make_serve_prefill,
                                    make_train_step)

_NO_COLLECTIVES = ("eager PyTorch has no partitioner, so no collective is "
                   "placed to count; a count needs DTensor over a fake "
                   "process group (CommDebugMode)")


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


def build_step(cfg: ArchConfig, shape: InputShape, mesh, plan: MeshPlan):
    """Call under ``FakeTensorMode``: (step, its arguments' shardings,
    the arguments), the step a closure over shape-only arguments."""
    params = tfm.init_params(torch.Generator(), cfg)
    params_sh = param_shardings(params, cfg, mesh, plan)
    batch = input_specs(cfg, shape)
    if shape.mode == "train":
        step, opt = make_train_step(
            cfg, runtime=Runtime(want_signature=True),
            microbatches=getattr(plan, "_microbatches", 0) or 1)
        opt_state = opt.init(params)
        shardings = [params_sh, opt_state_shardings(opt_state, params_sh,
                                                    mesh),
                     batch_shardings(batch, mesh, plan)]
        return (lambda: step(params, opt_state, batch), shardings,
                [params, opt_state, batch])
    if shape.mode == "prefill":
        fn = make_serve_prefill(cfg, Runtime())
        return (lambda: fn(params, batch),
                [params_sh, batch_shardings(batch, mesh, plan)],
                [params, batch])
    fn = make_serve_decode(cfg, Runtime())
    caches = tfm.init_cache(cfg, shape.global_batch, shape.seq_len)
    token = {"tokens": batch["token"]}
    return (lambda: fn(params, batch["token"], caches, batch["pos"]),
            [params_sh, batch_shardings(token, mesh, plan),
             cache_shardings(caches, cfg, mesh, plan)],
            [params, token, caches])


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
        with FakeTensorMode(allow_non_fake_inputs=True):
            step, shardings, args = build_step(cfg, shape, mesh, plan)
            t_build = time.time() - t0
            with CostCount() as cost:
                step()
        t_count = time.time() - t0 - t_build
        args_b = argument_bytes_per_chip(shardings, args)
        flops = cost.flops / n_chips
        bytes_acc = cost.bytes / n_chips
        mf = model_flops(cfg, shape)
        t_compute = flops / PEAK_FLOPS_BF16
        t_memory = bytes_acc / HBM_BW
        terms = {"compute_s": t_compute, "memory_s": t_memory}
        dominant = max(terms, key=terms.get)
        record.update({
            "ok": True,
            "build_s": round(t_build, 2), "count_s": round(t_count, 2),
            "flops_global": cost.flops, "bytes_global": cost.bytes,
            "flops_per_chip": flops,
            "bytes_per_chip": bytes_acc,
            "argument_bytes_per_chip": args_b,
            "argument_gib_per_chip": args_b / 2 ** 30,
            "collective_bytes_per_chip": None,
            "collectives": None,
            "collective_reason": _NO_COLLECTIVES,
            "model_flops_global": mf,
            "model_flops_per_chip": mf / n_chips,
            "useful_flop_ratio": (mf / n_chips) / flops if flops else None,
            "roofline": dict(terms, collective_s=None),
            "dominant": dominant,
            "step_time_bound_s": max(terms.values()),
            "ops_counted": sum(cost.ops.values()),
            "hardware": "NVIDIA H100 SXM published peaks: "
                        f"{PEAK_FLOPS_BF16:.3g} FLOP/s bf16, "
                        f"{HBM_BW:.3g} B/s HBM",
            "assumptions": "FLOPs and bytes per chip = global / chips; "
                           "argument bytes exact from the sharding rules",
        })
        if verbose:
            print(f"[{arch} x {shape_name}"
                  f"{' x multipod' if multi_pod else ''}] OK "
                  f"build={t_build:.1f}s count={t_count:.1f}s")
            print(f"  args/chip={args_b / 2 ** 30:.2f}GiB "
                  f"flops/chip={flops:.3e} bytes/chip={bytes_acc:.3e}")
            print(f"  terms: compute={t_compute * 1e3:.2f}ms "
                  f"memory={t_memory * 1e3:.2f}ms -> {dominant} dominates; "
                  f"useful-flop ratio={record['useful_flop_ratio']}")
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
