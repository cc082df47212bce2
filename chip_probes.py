#!/usr/bin/env python3
"""Probes on one CUDA card behind the sizes and the remat readings of
``chip_smoke.py``'s training legs (PERF.md section 5).  Run from the root
of a checkout:

    python3 chip_probes.py memory   # the train legs past their sizes
    python3 chip_probes.py remat    # train_local with remat on and off
    python3 chip_probes.py store    # a host-resting model store's copies
    python3 chip_probes.py host     # host memory as a store fills, empties
    python3 chip_probes.py grads    # a client's peak, step gradients held
    python3 chip_probes.py sharded_m  # the sharded LM's AdamW m, by leaf

``memory`` builds the kernels and runs ``chip_smoke.moe_train_leg`` (10
AdamW steps of ``launch.train.train_single``, with every gate of the leg)
on gemma2-2b at batches 6, 7 and 8 of 1,024 tokens and on qwen2-7b cut
to 10, 11 and 12 layers at 8 x 512: each run prints its record, or the
gate it failed, or that it ran out of memory.

``remat`` runs ``LMBackend.train_local`` (2 SGD steps at 8 x 512) at the
LM, hybrid and xLSTM paths' configs (xlstm-125m whole and as the loop's
one period), with the default runtime's ``remat`` set on and off in
turns after one warm-up of each: ms a step and peak by setting.

``store`` reads the host's memory (``/proc/meminfo``), then copies
Jamba's MoE cut (``chip_smoke.hybrid_moe_config``, 14.72 GB in float32)
from the card to host memory and back, tree by tree, in turns: by
``Tensor.to`` (pageable memory, the driver's own staging), by
``core.dag.PinnedStaging`` (two pinned buffers of 128 MiB, of 32 MiB,
its default, and of 8 MiB), and through a pinned copy of the host tree (the time to pin it
reported apart); each way's seconds and GB/s.  Then the peak of one
``LMBackend.train_local`` call (2 SGD steps) from a model fetched from
host memory, with the caller holding the aggregate and with the
aggregate passed as a temporary that the call frees once it has its
clone, at 8 x 512 and 4 x 512 for Jamba's cut and at 8 x 512 for
gemma2-2b whole (no kernel runs in training, so nothing is built).

``host`` puts Jamba's MoE cut into a ``core.dag.ModelStore("cpu")`` five
times (73.6 GB of host memory, as ``dag_moe``'s store holds), reading
each put's seconds and the host's MemAvailable after it, then fetches
each model back to the card (seconds), empties the store and reads
MemAvailable at once, after ``gc.collect()``, after glibc's
``malloc_trim(0)`` and 2, 10 and 30 s later: whether the memory of one
leg's store comes back before the next leg.

``grads`` runs one ``LMBackend.train_local`` call (2 SGD steps, no
kernel) from a host model copied to the card, as the DAG loop passes its
aggregate, at deepseek-v2's cut (``chip_smoke.mla_config``, 20.77 GB) at
8, 4 and 1 x 512 and at Jamba's MoE cut at 8 x 512, twice each: as
``train_local`` runs, each step's gradients freed before the next step,
and with each step's gradients held until the next step's update, as the
``grads`` tree of ``train_local`` held them before: the peak, the
allocator's retries, or the out-of-memory message.

``sharded_m`` builds the kernels and runs the sharded LM's training step
(``chip_smoke.sharded_lm_legs``' ``sharded_lm_train``: internlm2-1.8b at
full width, float32, one AdamW step at 8 x 512 on the (4, 2) mesh of
threads over the card) at 2 and 4 layers, without its gates: for each
leaf, AdamW's m off the unsharded step's at microbatches 1 (the leg's
reference), of the leaf's largest, for the sharded step at microbatches
1 and 4 and for the unsharded step at microbatches 2 and 4 (the same
sums in other float32 orders); the five leaves worst for the sharded
step, and each order's worst.

Each measurement prints one JSON line; the card's name and power limit
come first.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time

import chip_smoke as cs


def memory_probe(dev) -> None:
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm as ml
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.kernels import signature as sig
    from repro_torch.kernels import slstm as sl

    cs.phase_build(build)
    kern = {"sig": sig, "fa": fa, "ss": ss, "ml": ml, "sl": sl}
    runs = [("gemma2-2b", cs.gemma2_config(), batch, 1024, None)
            for batch in (6, 7, 8)]
    for layers in (10, 11, 12):
        cut = dataclasses.replace(cs.qwen2_train_config(), n_layers=layers,
                                  stages=(dataclasses.replace(
                                      cs.qwen2_config().stages[0],
                                      repeats=layers),))
        runs.append(("qwen2-7b", cut, 8, 512, layers))
    for model, cfg, batch, seq, layers in runs:
        probe = {"probe": "memory", "model": model, "layers": cfg.n_layers,
                 "batch": batch, "seq_len": seq}
        try:
            record = cs.moe_train_leg(
                kern, dev, cfg, leg=f"probe_{model}", phase="chip_probes",
                batch=batch, seq=seq,
                expected_params=cs.tree_param_count(cfg))
            probe.update(ok=True, peak_bytes=record["peak_bytes"],
                         alloc_retries=record["alloc_retries"],
                         ms_per_step=record["ms_per_step"])
        except SystemExit as failed:
            probe.update(ok=False, failed=str(failed),
                         peak_bytes=torch.cuda.max_memory_allocated())
        except torch.cuda.OutOfMemoryError:
            probe.update(ok=False, failed="out of memory",
                         peak_bytes=torch.cuda.max_memory_allocated())
        probe["card_bytes"] = torch.cuda.get_device_properties(
            0).total_memory
        gc.collect()
        torch.cuda.empty_cache()
        cs.emit(**probe)


def remat_probe(dev) -> None:
    import torch
    from repro_torch.fl.backend import LMBackend
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import Runtime

    streams, _ = cs.lm_streams(1)
    default = tfm.loss_fn.__defaults__

    def steps(backend, params, remat: bool):
        """2 steps of train_local with the default runtime's remat set:
        (ms a step, peak bytes)."""
        tfm.loss_fn.__defaults__ = (Runtime(remat=remat),)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trained, _ = backend.train_local(params, streams[0], epochs=2)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / 2
        del trained
        return ms, torch.cuda.max_memory_allocated()

    try:
        for name, cfg, pairs in (("lm", cs.lm_config(), 2),
                                 ("hybrid", cs.hybrid_config(), 1),
                                 ("xlstm", cs.xlstm_config(), 1),
                                 ("xlstm_loop", cs.xlstm_loop_config(), 1)):
            backend = LMBackend(cfg, lr=3e-3, local_steps=2, batch_size=8,
                                seq_len=512)
            params = backend.init(torch.Generator(device=dev).manual_seed(0))
            steps(backend, params, False)         # warm-up of each
            steps(backend, params, True)
            runs = {"remat": [], "no_remat": []}
            for turn in range(2 * pairs):
                for remat in ((False, True) if turn % 2 == 0
                              else (True, False)):
                    runs["remat" if remat else "no_remat"].append(
                        steps(backend, params, remat))
            cs.emit(probe="remat", config=name, model=cfg.name,
                    layers=cfg.n_layers, batch=8, seq_len=512,
                    ms_per_step={k: [ms for ms, _ in v]
                                 for k, v in runs.items()},
                    peak_bytes={k: max(p for _, p in v)
                                for k, v in runs.items()})
            del params, backend
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        tfm.loss_fn.__defaults__ = default


def store_probe(dev) -> None:
    import torch
    from repro_torch.core.aggregate import (tree_leaves, tree_map,
                                            tree_size_bytes)
    from repro_torch.core.dag import PinnedStaging
    from repro_torch.fl.backend import LMBackend

    cs.emit(probe="store", host=cs.meminfo(), threads=torch.get_num_threads())

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def pinned_copy(host):
        """The host tree pinned (timed apart), then copied to the card."""
        pinned, pin_s = timed(lambda: tree_map(
            lambda t: t.pin_memory(), host))
        back, s = timed(lambda: tree_map(
            lambda t: t.to(dev, non_blocking=True), pinned))
        return back, s, pin_s

    backend = LMBackend(cs.hybrid_moe_config(), lr=3e-3, local_steps=2,
                        batch_size=8, seq_len=512)
    model = backend.init(torch.Generator(device=dev).manual_seed(0))
    size = tree_size_bytes(model)
    ways = {"to": lambda t, d: t.to(d),
            "staged_128MiB": PinnedStaging(1 << 27).copy,
            "staged_32MiB": PinnedStaging(1 << 25).copy,
            "staged_8MiB": PinnedStaging(1 << 23).copy}
    order = ["to", "staged_128MiB", "staged_32MiB", "staged_8MiB", "pinned",
             "pinned", "staged_8MiB", "staged_32MiB", "staged_128MiB", "to"]
    cpu = torch.device("cpu")
    for way in order:
        copy = ways.get(way, ways["to"])
        host, down_s = timed(lambda: tree_map(lambda t: copy(t, cpu), model))
        record = {"probe": "store_copy", "way": way, "bytes": size,
                  "to_host_s": down_s, "to_host_gb_s": size / down_s / 1e9}
        if way == "pinned":
            back, up_s, record["pin_s"] = pinned_copy(host)
        else:
            back, up_s = timed(lambda: tree_map(lambda t: copy(t, dev),
                                                host))
        record.update(to_card_s=up_s, to_card_gb_s=size / up_s / 1e9,
                      equal=all(torch.equal(a, b) for a, b in zip(
                          tree_leaves(model), tree_leaves(back))),
                      rss_peak_bytes=cs.host_peak_bytes())
        del host, back
        gc.collect()
        cs.emit(**record)
    host = tree_map(lambda t: t.to(cpu), model)
    del model
    streams, _ = cs.lm_streams(1)

    def train_peak(backend, host, held: bool):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        t0 = time.perf_counter()
        if held:
            agg = tree_map(lambda t: t.to(dev), host)
            trained, _ = backend.train_local(agg, streams[0], seed=1)
            del agg
        else:
            trained, _ = backend.train_local(
                tree_map(lambda t: t.to(dev), host), streams[0], seed=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        del trained
        return {"peak_bytes": torch.cuda.max_memory_allocated(),
                "alloc_retries": torch.cuda.memory_stats().get(
                    "num_alloc_retries", 0) - retries, "wall_s": wall}

    runs = [("jamba_moe", backend, 8, True), ("jamba_moe", backend, 8, False),
            ("jamba_moe", backend, 4, False)]
    for name, backend, batch, held in runs:
        backend.batch_size = batch
        try:
            record = train_peak(backend, host, held)
        except torch.cuda.OutOfMemoryError:
            record = {"failed": "out of memory",
                      "peak_bytes": torch.cuda.max_memory_allocated()}
        cs.emit(probe="store_train", config=name, batch=batch, seq_len=512,
                aggregate_held=held, model_bytes=size,
                card_bytes=torch.cuda.get_device_properties(0).total_memory,
                **record)
    del host
    gc.collect()
    backend = LMBackend(cs.gemma2_config(), lr=3e-3, local_steps=2,
                        batch_size=8, seq_len=512)
    model = backend.init(torch.Generator(device=dev).manual_seed(0))
    host = tree_map(lambda t: t.to(cpu), model)
    size = tree_size_bytes(model)
    del model
    for held in (True, False):
        try:
            record = train_peak(backend, host, held)
        except torch.cuda.OutOfMemoryError:
            record = {"failed": "out of memory",
                      "peak_bytes": torch.cuda.max_memory_allocated()}
        cs.emit(probe="store_train", config="gemma2", batch=8, seq_len=512,
                aggregate_held=held, model_bytes=size,
                card_bytes=torch.cuda.get_device_properties(0).total_memory,
                **record)


def host_probe(dev) -> None:
    import ctypes

    import torch
    from repro_torch.core.aggregate import tree_size_bytes
    from repro_torch.core.dag import ModelStore
    from repro_torch.fl.backend import LMBackend

    backend = LMBackend(cs.hybrid_moe_config(), local_steps=2, batch_size=8,
                        seq_len=512)
    model = backend.init(torch.Generator(device=dev).manual_seed(0))
    size = tree_size_bytes(model)
    store = ModelStore("cpu")
    cs.emit(probe="host", step="start", bytes=size, host=cs.meminfo())
    for i in range(5):
        before = store.readings()["in_s"]
        store.put(f"m{i}", model)
        cs.emit(probe="host", step=f"put {i}", bytes=size,
                seconds=store.readings()["in_s"] - before,
                host=cs.meminfo())
    del model
    gc.collect()
    torch.cuda.empty_cache()
    for i in range(5):
        before = store.readings()["out_s"]
        fetched = store.get(f"m{i}", dev)
        del fetched
        cs.emit(probe="host", step=f"get {i}", bytes=size,
                seconds=store.readings()["out_s"] - before)
    del store
    cs.emit(probe="host", step="freed", host=cs.meminfo())
    gc.collect()
    cs.emit(probe="host", step="gc", host=cs.meminfo())
    trimmed = ctypes.CDLL("libc.so.6").malloc_trim(0)
    cs.emit(probe="host", step="malloc_trim", returned=trimmed,
            host=cs.meminfo())
    for wait in (2, 8, 20):
        time.sleep(wait)
        cs.emit(probe="host", step=f"after {wait} s more", host=cs.meminfo())


def grads_probe(dev) -> None:
    import torch
    from repro_torch.core.aggregate import tree_map, tree_size_bytes
    from repro_torch.core.dag import ModelStore, PinnedStaging
    from repro_torch.fl.backend import LMBackend

    staging = PinnedStaging()
    streams, _ = cs.lm_streams(1)
    for name, cfg, batches in (("mla", cs.mla_config(), (8, 4, 1)),
                               ("jamba_moe", cs.hybrid_moe_config(), (8,))):
        host = ModelStore("cpu").rest(cs.draw_genesis(cfg, dev))
        for batch in batches:
            for held in (False, True):
                backend = LMBackend(cfg, lr=3e-3, local_steps=2,
                                    batch_size=batch, seq_len=512)
                if held:                   # the previous step's gradients
                    kept, update = [], backend.opt.update  # live on

                    def holding(grads, *a, _kept=kept, _update=update):
                        _kept[:] = [grads]
                        return _update(grads, *a)
                    backend.opt = backend.opt._replace(update=holding)
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                stats = torch.cuda.memory_stats()
                retries = stats.get("num_alloc_retries", 0)
                try:
                    trained, _ = backend.train_local(
                        tree_map(lambda t: staging.copy(t, dev), host),
                        streams[0], seed=0)
                    del trained
                    torch.cuda.synchronize()
                    failed = None
                except torch.cuda.OutOfMemoryError as e:
                    failed = str(e).split(". ")[0][:300]
                if held:
                    kept.clear()
                cs.emit(probe="grads", config=name, batch=batch,
                        seq_len=512, gradients_held=held,
                        model_bytes=tree_size_bytes(host),
                        peak_bytes=torch.cuda.max_memory_allocated(),
                        alloc_retries=torch.cuda.memory_stats().get(
                            "num_alloc_retries", 0) - retries,
                        failed=failed, card_bytes=torch.cuda
                        .get_device_properties(0).total_memory)
        del host


def sharded_m_probe(dev) -> None:
    import torch
    from repro_torch.configs.base import InputShape, Stage
    from repro_torch.core.aggregate import tree_map
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import run_on_chips
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding.rules import MeshPlan

    cs.phase_build(build)
    B, S = cs.SHARDED_BATCH
    mesh = cs.sharded_mesh(cs.SHARDED_MESH)

    def plan(microbatches):
        p = MeshPlan()
        object.__setattr__(p, "_microbatches", microbatches)
        return p

    for layers in (2, 4):
        lm = cs.lm_config()
        cfg = cs.sharded_config(dataclasses.replace(
            lm, n_layers=layers, stages=(Stage(lm.stages[0].pattern,
                                               layers),)))
        weights = tfm.init_params(
            torch.Generator(device=dev).manual_seed(0), cfg)
        batch = cs.lm_batch(dev, cfg, B, S, 1)
        m1 = cs.unsharded_train(cfg, weights, batch, mesh)[4]
        orders = {}
        for mb in (2, 4):                  # the same sums, other orders
            step, _, _ = dryrun.build_step(
                cfg, InputShape("unsharded", S, B, "train"), mesh,
                plan(mb), params=tree_map(lambda a: a.clone(), weights),
                batch=batch)
            orders[f"unsharded_mb{mb}"] = cs._tree_paths(step()[1]["m"])
        for mb in (1, 4):
            def chip(dmesh, mb=mb):
                rank0 = dmesh.get_rank() == 0
                step, _, _ = dryrun.build_step(
                    cfg, InputShape("sharded", S, B, "train"), mesh,
                    plan(mb), dmesh, params=weights, batch=batch)
                m = {path: cs.gathered(t.detach(), rank0)   # every chip
                     for path, t in cs._tree_paths(step()[1]["m"]).items()}
                return m if rank0 else None
            orders[f"sharded_mb{mb}"] = run_on_chips(
                chip, mesh, cs.SHARDED_TIMEOUT)[0]
        rows = []
        for path, want in m1.items():
            scale = max(want.abs().max().item(), 1e-30)
            rows.append({"leaf": "/".join(map(str, path)), "scale": scale,
                         **{name: (m[path] - want).abs().max().item()
                            / scale for name, m in orders.items()}})
        rows.sort(key=lambda r: -r["sharded_mb1"])
        cs.emit(probe="sharded_m", layers=layers, mesh=list(cs.SHARDED_MESH),
                batch=B, seq_len=S, m_tol=cs.SHARDED_M_TOL, against=
                "the unsharded step at microbatches 1", worst=rows[:5],
                worst_by_order={name: max(rows, key=lambda r: r[name])
                                for name in orders})
        del weights, batch, m1, orders
        gc.collect()
        torch.cuda.empty_cache()


def main(argv) -> None:
    import torch
    probes = {"memory": memory_probe, "remat": remat_probe,
              "store": store_probe, "host": host_probe, "grads": grads_probe,
              "sharded_m": sharded_m_probe}
    if len(argv) != 1 or argv[0] not in probes:
        raise SystemExit("usage: chip_probes.py " + "|".join(probes))
    if not torch.cuda.is_available():
        raise SystemExit("chip_probes: CUDA is not available")
    from repro_torch import runtime
    from repro_torch.kernels import build
    dev = runtime.resolve_device("cuda")
    print(cs.phase_environment(build), flush=True)
    probes[argv[0]](dev)


if __name__ == "__main__":
    main(sys.argv[1:])
