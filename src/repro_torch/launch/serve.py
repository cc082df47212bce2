"""Serving launcher: batched prefill + greedy decode with a KV cache (port
of ``repro.launch.serve``).

The prefill/decode pair and the greedy KV-cache decode loop live here as
reusable functions (``make_serving_fns`` / ``greedy_decode`` /
``extend_caches``): the live-traffic consensus serving
(:mod:`repro_torch.fl.serving`) drives the same functions against DAG
frontier replicas that this CLI drives against freshly drawn weights.

The prefill runs on the kernels (``runtime.serve_runtime``): on the card
it launches flash attention, the selective scan and the mLSTM and sLSTM
kernels, on the CPU their plain versions.  The decode step is plain
PyTorch, as the reference's.  The reference's ``--kernel-policy`` has no
counterpart: ``--device`` (default: the CUDA card) decides.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import cache_seq_axis
from repro_torch.runtime import Runtime, resolve_device, serve_runtime
from repro_torch.train.step import make_serve_decode, make_serve_prefill


def extend_caches(caches, cfg, extra: int):
    """Grow every attention cache by ``extra`` zero slots along its
    SEQUENCE axis.  The axis is derived from the cache spec
    (:data:`repro_torch.models.attention.KV_CACHE_TRAILING_DIMS`, counted
    from the trailing end), not hardcoded: prefill-collected caches carry
    a leading stacked-layer axis, per-layer caches do not, and both
    layouts must extend correctly.  Other entries are passed through:
    the recurrent states, and the cross-attention layers' ``xk`` and
    ``xv``, which hold the encoder's frames, not the decoded tokens."""
    out = []
    for si, stage in enumerate(cfg.stages):
        d = {}
        for j, spec in enumerate(stage.pattern):
            cc = dict(caches[si][f"l{j}"])
            if spec.kind == "attn":
                for kk in ("k", "v", "ckv", "krope"):
                    if kk in cc:
                        a = cc[kk]
                        axis = cache_seq_axis(kk, a.dim())
                        shape = list(a.shape)
                        shape[axis] = extra
                        cc[kk] = torch.cat([a, a.new_zeros(shape)], dim=axis)
            d[f"l{j}"] = cc
        out.append(d)
    return out


def make_serving_fns(cfg, runtime: Optional[Runtime] = None):
    """The (prefill, decode) pair for one arch config, both under
    ``torch.inference_mode()``; ``runtime`` defaults to
    :func:`repro_torch.runtime.serve_runtime` (the prefill on the
    kernels)."""
    runtime = serve_runtime() if runtime is None else runtime
    return make_serve_prefill(cfg, runtime), make_serve_decode(cfg, runtime)


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def greedy_decode(prefill_fn, decode_fn, cfg, params, batch,
                  new_tokens: int, keep_logits: bool = False):
    """Prefill ``batch`` then greedy-decode ``new_tokens`` against the KV
    cache.  Returns {tokens (B, new_tokens) int32, prefill_s, decode_s,
    caches}; with ``keep_logits`` also ``logits`` (new_tokens, B, V): the
    prefill's last logits and each decode step's.  Both clock reads
    synchronise the card on the results; the decode steps themselves
    never wait on it (``pos`` is a Python int)."""
    tokens = batch["tokens"]
    prompt_len = tokens.shape[1]
    _sync(tokens)
    t0 = time.perf_counter()
    last_logits, caches = prefill_fn(params, batch)
    caches = extend_caches(caches, cfg, new_tokens)
    _sync(last_logits)
    t_prefill = time.perf_counter() - t0

    tok = last_logits.argmax(dim=-1).to(torch.int32)[:, None]
    generated = [tok]
    kept = [last_logits] if keep_logits else None
    t0 = time.perf_counter()
    for step in range(new_tokens - 1):
        tok, logits, caches = decode_fn(params, tok, caches,
                                        prompt_len + step)
        tok = tok[:, None]
        generated.append(tok)
        if keep_logits:
            kept.append(logits)
    _sync(tok)
    t_decode = time.perf_counter() - t0
    out = {"tokens": torch.cat(generated, dim=1), "prefill_s": t_prefill,
           "decode_s": t_decode, "caches": caches}
    if keep_logits:
        out["logits"] = torch.stack(kept)
    return out


def serve(cfg, batch: int, prompt_len: int, new_tokens: int, seed: int = 0,
          device=None, params=None, prompts=None, enc_embed=None,
          keep_logits: bool = False):
    """Prefill and greedy-decode one batch of prompts.  Weights, prompts
    and, for a config with an encoder, its input ``enc_embed`` (B, n_ctx,
    d) ~ N(0, 1) * 0.1 are drawn in that order from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (default: the CUDA card) unless
    given.  Returns the timings, ``decode_tok_per_s``, the tokens, the
    caches, the params, prompts and ``enc_embed`` used (None without an
    encoder), and the logits with ``keep_logits``."""
    device = resolve_device(device)
    prefill, decode = make_serving_fns(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    if params is None:
        params = tfm.init_params(gen, cfg)
    if prompts is None:
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                generator=gen, device=device)
    b = {"tokens": prompts}
    if cfg.encoder is not None:
        if enc_embed is None:
            enc_embed = torch.randn(
                (batch, cfg.encoder.n_ctx, cfg.d_model), generator=gen,
                device=device) * 0.1
        b["enc_embed"] = enc_embed
    r = greedy_decode(prefill, decode, cfg, params, b, new_tokens,
                      keep_logits=keep_logits)
    r.update(decode_tok_per_s=batch * (new_tokens - 1)
             / max(r["decode_s"], 1e-9), params=params, prompts=prompts,
             enc_embed=enc_embed)
    return r


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="internlm2-1.8b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(reduced(cfg), compute_dtype="float32")
    r = serve(cfg, args.batch, args.prompt, args.new_tokens, seed=args.seed,
              device=args.device)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt} "
          f"new={args.new_tokens}")
    print(f"prefill={r['prefill_s']*1e3:.1f}ms "
          f"decode={r['decode_s']*1e3:.1f}ms "
          f"({r['decode_tok_per_s']:.1f} tok/s)")
    print("sample:", r["tokens"][0, :12].tolist())
    return r


if __name__ == "__main__":
    main()
