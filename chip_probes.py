#!/usr/bin/env python3
"""Probes on one CUDA card behind the sizes and the remat readings of
``chip_smoke.py``'s training legs (PERF.md section 5).  Run from the root
of a checkout:

    python3 chip_probes.py memory   # the train legs past their sizes
    python3 chip_probes.py remat    # train_local with remat on and off

``memory`` builds the kernels and runs ``chip_smoke.moe_train_leg`` (10
AdamW steps of ``launch.train.train_single``, with every gate of the leg)
on gemma2-2b at batches 6, 7 and 8 of 1,024 tokens and on qwen2-7b cut
to 10, 11 and 12 layers at 8 x 512: each run prints its record, or the
gate it failed, or that it ran out of memory.

``remat`` runs ``LMBackend.train_local`` (2 SGD steps at 8 x 512) at the
LM, hybrid and xLSTM paths' configs (xlstm-125m whole and as the loop's
one period), with the default runtime's ``remat`` set on and off in
turns after one warm-up of each: ms a step and peak by setting.

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


def main(argv) -> None:
    import torch
    if len(argv) != 1 or argv[0] not in ("memory", "remat"):
        raise SystemExit("usage: chip_probes.py memory|remat")
    if not torch.cuda.is_available():
        raise SystemExit("chip_probes: CUDA is not available")
    from repro_torch import runtime
    from repro_torch.kernels import build
    dev = runtime.resolve_device("cuda")
    print(cs.phase_environment(build), flush=True)
    {"memory": memory_probe, "remat": remat_probe}[argv[0]](dev)


if __name__ == "__main__":
    main(sys.argv[1:])
