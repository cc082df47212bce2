#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. environment: torch, CUDA, nvcc, the card and its power limit;
2. build: every CUDA source of the port compiled with nvcc for sm_90a,
   one nvcc per source, all started together;
3. kernels against their plain PyTorch versions on the card, bit for bit,
   at the main path's shape and at ragged shapes, then timed;
4. the main path: the sequential DAG-AFL loop over four full-width VGG16
   clients on 32x32x3 images, driven through ``CNNBackend`` and
   ``DagAflCoordinator.run``, with every kernel's launch count set to 0
   just before and read just after; and the card's forward pass held
   against the port's CPU forward on a small input.

Then one line ``{"kernels": [...]}`` with each kernel's launches on the
main path, its error against the plain version and its times beside its
bound; the card's name and power limit as ``nvidia-smi`` prints them; and
last ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
without that last line, as does a host without CUDA or a directory that
holds this script and nothing else of the repository.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 rate outside the
# tensor cores, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
MAIN_SHAPE = (128, 1024, 64)   # VGG16 conv 1 at 32x32, 128 samples
RAGGED_SHAPE = (3, 1000, 63)


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def relu_like(shape, generator, tau=0.05):
    """ReLU output (about half exact zeros) with values at and beside the
    float32 tau and a few negative zeros, where the comparisons decide."""
    import torch
    x = torch.relu(torch.randn(shape, generator=generator,
                               device=generator.device) * 0.2)
    flat = x.view(-1)
    t = torch.tensor(tau, dtype=torch.float32, device=x.device)
    edges = torch.stack([t, torch.nextafter(t, torch.zeros_like(t)),
                         torch.nextafter(t, torch.ones_like(t)),
                         torch.zeros_like(t).neg()])
    idx = torch.randint(0, flat.numel(), (4096,), generator=generator,
                        device=x.device)
    flat[idx] = edges.repeat(1024)
    return x


def device_ms(fn, inputs, reps: int = 60) -> float:
    """Device time of one call, from CUDA events around ``reps`` calls that
    rotate over ``inputs`` (together larger than the 50 MB L2, so each call
    reads device memory).  The card first sleeps while the host enqueues
    every call, so host overhead leaves no gaps between them."""
    import torch
    for x in inputs:
        fn(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for i in range(reps):
        fn(inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_environment(build) -> str:
    import importlib.util

    import torch
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    triton = None
    if importlib.util.find_spec("triton") is not None:
        import triton
        triton = triton.__version__
    emit(phase="environment", python=sys.version.split()[0],
         torch=torch.__version__, torch_cuda=torch.version.cuda,
         triton=triton,
         nvcc=run([build._nvcc(), "--version"]).splitlines()[-1],
         device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), nvidia_smi=smi)
    return smi


def phase_build(build) -> None:
    t0 = time.perf_counter()
    paths = build.build()
    seconds = time.perf_counter() - t0
    ptxas = {name: [line.strip() for line in
                    build.log_path(name).read_text().splitlines()
                    if "registers" in line or "spill" in line]
             for name in paths}
    emit(phase="build", seconds=seconds,
         libraries=[str(p.relative_to(ROOT)) for p in paths.values()],
         ptxas=ptxas)


def phase_kernels(sig, ops, dev) -> dict:
    """Kernel against plain version, bit for bit; then times."""
    import torch
    g = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    compared = []
    for shape in (MAIN_SHAPE, RAGGED_SHAPE):
        for tau in (0.0, 0.05):
            x = relu_like(shape, g)
            strided = x.transpose(1, 2).contiguous().transpose(1, 2)
            pairs = [
                (sig.signature_counts(x, tau),
                 sig.signature_counts_plain(x, tau)),
                (sig.signature_counts(strided, tau),
                 sig.signature_counts_plain(x, tau)),
                (sig.signature_counts(x, tau, mean=True),
                 sig.signature_counts_plain(x, tau, mean=True)),
                (sig.signature_td(x[0], tau=tau),
                 sig.signature_td_plain(x[0], tau=tau)),
            ]
            torch.cuda.synchronize()
            for got, want in pairs:
                check(got.is_cuda and got.shape == want.shape,
                      f"signature kernel output at {shape}, tau {tau}")
                err = (got - want).abs().max().item()
                max_err = max(max_err, err)
                check(torch.equal(got, want),
                      f"signature kernel != plain at {shape}, tau {tau}: "
                      f"max |diff| {err}")
            compared.append({"shape": list(shape), "tau": tau})
    # the model-facing wrapper on a channels-last activation
    act = relu_like((16, 64, 32, 32), g).to(memory_format=torch.channels_last)
    nhwc = act.permute(0, 2, 3, 1)
    got = ops.signature_per_channel(nhwc)
    want = (sig.signature_counts_plain(nhwc.reshape(16, -1, 64), 0.0)
            * float(1 / 1024))
    check(torch.equal(got, want), "signature_per_channel on the card")

    n, t, c = MAIN_SHAPE
    inputs = [relu_like(MAIN_SHAPE, g) for _ in range(4)]
    ms = device_ms(lambda x: sig.signature_counts(x, 0.0), inputs)
    plain_ms = device_ms(lambda x: sig.signature_counts_plain(x, 0.0),
                         inputs)
    library_ms = device_ms(lambda x: t - torch.count_nonzero(x, dim=1),
                           inputs)
    bytes_moved = n * t * c * 4 + n * c * 4
    ops_done = 2 * n * t * c                  # one compare, one add
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S,
                   ops_done / F32_OPS_PER_S) * 1e3
    record = {"name": "signature_counts", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/signature.cu",
              "replaces": "src/repro/kernels/signature.py:45",
              "max_abs_err": max_err, "ms": ms, "kernel_ms": ms,
              "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": ("bytes" if bytes_moved / HBM_BYTES_PER_S
                           >= ops_done / F32_OPS_PER_S else "operations"),
              "library_ms": library_ms, "timed_shape": list(MAIN_SHAPE)}
    emit(phase="kernels_vs_plain", compared=compared, **record)
    return record


def reference_check(cnn, cfg, dev, params) -> dict:
    """The card's VGG16 forward against the port's CPU forward on a small
    input, from the same weights: logits within float32 convolution noise,
    signatures within a few ReLU sign flips."""
    import torch
    from repro_torch.core.aggregate import tree_map
    x = relu_like((8, 32, 32, 3), torch.Generator(device=dev).manual_seed(1),
                  tau=0.5) - 0.25
    with torch.inference_mode():
        logits, sig = cnn.cnn_forward(params, x, cfg, want_signature=True)
        cpu_params = tree_map(lambda p: p.cpu(), params)
        ref_logits, ref_sig = cnn.cnn_forward(cpu_params, x.cpu(), cfg,
                                              want_signature=True)
    logit_err = (logits.cpu() - ref_logits).abs().max().item()
    sig_err = (sig.cpu() - ref_sig).abs().max().item()
    scale = ref_logits.abs().max().item()
    check(torch.isfinite(logits).all().item(), "non-finite logits")
    check(logit_err <= 1e-3 * max(scale, 1.0),
          f"card logits differ from CPU by {logit_err} (scale {scale})")
    check(sig_err <= 0.01, f"card signature differs from CPU by {sig_err}")
    return {"logits_max_abs_err": logit_err, "logits_scale": scale,
            "signature_max_abs_err": sig_err}


def phase_main_path(sig, dev) -> int:
    import numpy as np
    import torch
    from repro_torch.configs.cnn import vgg_for
    from repro_torch.core.aggregate import tree_leaves
    from repro_torch.core.coordinator import DagAflConfig, DagAflCoordinator
    from repro_torch.core.verify import verify_full_dag
    from repro_torch.data.partition import partition_dirichlet
    from repro_torch.data.synthetic import make_image_dataset, split_811
    from repro_torch.fl.backend import CNNBackend
    from repro_torch.models import cnn

    cfg = vgg_for("cifar10", tiny=False)
    ds = make_image_dataset("cifar10", 2400, 10, 32, 3, 0.55)
    splits = split_811(ds)
    parts = partition_dirichlet(splits["train"], 4, beta=1.0, seed=0)
    client_data = []
    for p in parts:
        s = split_811(p, seed=1)
        client_data.append({"train": s["train"], "val": s["val"],
                            "test": s["test"]})
    backend = CNNBackend(cfg, local_epochs=1, batch_size=64)
    check(backend.device.type == "cuda", "backend is not on the card")
    # warm-up outside the counted run: cuDNN plans, allocator pools
    warm = backend.init(torch.Generator().manual_seed(1))
    backend.evaluate(backend.train_local(warm, client_data[0]["train"],
                                         epochs=1)[0], client_data[0]["val"])
    del warm

    # Each backend call ends in a host copy (float(...) or .cpu()), so a
    # host clock around it covers its device work.
    calls = {"train_local": 0, "evaluate": 0, "signature": 0, "plain": 0}
    seconds = {"train_local": 0.0, "evaluate": 0.0, "signature": 0.0}
    signatures = []

    def counted(name, fn, keep=None):
        def wrapper(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            calls[name] += 1
            if name in seconds:
                seconds[name] += time.perf_counter() - t
            if keep is not None:
                keep.append(out)
            return out
        return wrapper

    inner_plain = sig.signature_counts_plain
    backend.train_local = counted("train_local", backend.train_local)
    backend.evaluate = counted("evaluate", backend.evaluate)
    backend.signature = counted("signature", backend.signature, signatures)
    sig.signature_counts_plain = counted("plain", inner_plain)
    coord = DagAflCoordinator(backend, client_data, splits["test"],
                              DagAflConfig(n_clients=4, max_rounds=2,
                                           local_epochs=1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sig.launches = 0                           # counts start here
    t0 = time.perf_counter()
    result = coord.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sig.launches                    # and are read here
    sig.signature_counts_plain = inner_plain
    seconds["rest"] = wall - sum(seconds.values())
    peak = torch.cuda.max_memory_allocated()

    rounds = result.rounds
    accs = [result.final_accuracy, result.best_accuracy,
            result.extra["tip_mean_accuracy"],
            result.extra["client_mean_accuracy"]]
    accs += [a for _, a in result.history]
    gm = coord.global_model()
    ok, why = verify_full_dag(coord.ledger)
    check(rounds == 8, f"expected 8 rounds (4 clients x 2), got {rounds}")
    check(result.extra["chain_len"] == 1 + rounds,
          f"chain_len {result.extra['chain_len']} != 1 + {rounds}")
    check(result.extra["verify_failures"] == 0, "path verification failed")
    check(ok, f"verify_full_dag: {why}")
    check(launches == calls["signature"] == rounds,
          f"signature kernel launched {launches} times for "
          f"{calls['signature']} signature calls over {rounds} rounds")
    check(calls["plain"] == 0, "the main path ran the plain signature")
    check(all(np.isfinite(a) and 0.0 <= a <= 1.0 for a in accs),
          f"accuracies {accs}")
    check(all(p.is_cuda for p in tree_leaves(gm)), "model left the card")
    check(all(s.shape == (64,) and np.all((s >= 0) & (s <= 1))
              for s in signatures), "signatures are not 64 fractions")
    ref = reference_check(cnn, cfg, dev, gm)
    emit(phase="main_path", model=cfg.name, image=[32, 32, 3],
         n_params=sum(p.numel() for p in tree_leaves(gm)),
         clients=4, rounds=rounds, chain_len=result.extra["chain_len"],
         wall_s=wall, s_per_round=wall / rounds, peak_bytes=peak,
         final_accuracy=result.final_accuracy,
         tip_mean_accuracy=result.extra["tip_mean_accuracy"],
         client_mean_accuracy=result.extra["client_mean_accuracy"],
         calls=calls, seconds=seconds, signature_launches=launches,
         verify_full_dag=why, **ref)
    return launches


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    from repro_torch import runtime
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import signature as sig

    dev = runtime.resolve_device("cuda")
    smi = phase_environment(build)
    phase_build(build)
    record = phase_kernels(sig, ops, dev)
    record["launches"] = phase_main_path(sig, dev)
    print(json.dumps({"kernels": [record]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
