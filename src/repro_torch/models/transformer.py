"""Staged decoder, and optional encoder, assembled from an ArchConfig
(port of ``repro.models.transformer``: the dense GQA path with sliding
windows past 2,048 tokens and M-RoPE, MLA attention, Jamba's hybrid of
Mamba and attention blocks, xLSTM's mLSTM and sLSTM blocks, and whisper's
encoder with the decoder's cross-attention).

The layer stack is organised as *stages*, as in the reference: each stage
is a repeating pattern of blocks whose parameters are stacked along a
leading ``repeats`` axis (``params["stages"][s]["l{j}"]``), so a JAX
parameter tree loads through ``weights.params_from_numpy`` unchanged.  The
reference scans that axis with ``lax.scan``; here a Python loop takes
period ``i`` as the leaves' index ``i``.

Public API: init_params / init_cache / forward_hidden /
per_sample_signature / forward / loss_fn / prefill / decode_step.
Attention, Mamba, mLSTM and sLSTM blocks, with dense feed-forward layers,
mixture-of-experts ones (``models.moe``) or none (``ffn="none"``, or
``d_ff = 0``).

With ``cfg.encoder`` set, ``batch["enc_embed"]`` (B, n_ctx, d) is the
encoder's input (the frontend's frame embeddings, a stub in the
reference): its layers (``params["encoder"]["layers"]``, stacked on a
leading axis) run non-causal attention, which the flash kernel never takes
(its dispatch needs causal attention), and each cross-attention layer of
the decoder attends to the encoder's output after its self-attention.
Prefill puts that layer's cross keys and values into its cache (``xk``,
``xv``); a decode step reads them and never writes them.

``mode`` is the reference's: ``"train"`` (the default, and ``loss_fn``'s)
gives the MoE layers Switch-style capacity, which drops tokens; any other
mode (``"prefill"``: the evaluation, signature and serving forwards) the
generous capacity of serving, and a decode step routes one token a row,
which is generous too.  ``aux["moe_aux"]`` sums the MoE layers' router
losses in the reference's layer order (0 for a model without them).

Serving: ``prefill`` runs the full-sequence forward (on the kernels with
``runtime.use_kernels``) and collects each layer's cache (the attention
layers' roped keys and values, the recurrent blocks' final states),
stacked on each stage's ``repeats`` axis as the reference's scan stacks
them; ``decode_step`` runs one token through every layer against those
caches, in plain PyTorch as the reference's decode.  ``pos`` is a Python
int, so a step never waits on the card, and the caches are updated in
place: ``decode_step`` returns the caches it was given.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.core.aggregate import tree_leaves, tree_map
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xl
from repro_torch.models.layers import (apply_mlp, apply_norm, apply_rope,
                                       embed_tokens, init_embedding,
                                       init_mlp, init_norm, torch_dtype,
                                       unembed)
from repro_torch.runtime import DEFAULT, Runtime
from repro_torch.sharding import dtensor
from repro_torch.sharding.dtensor import merge_heads, shard_batch, summed


# ---------------------------------------------------------------------------
# window resolution (long-context adaptation)
# ---------------------------------------------------------------------------


def _arch_is_subquadratic(cfg: ArchConfig) -> bool:
    return any(s.window > 0 or s.kind in ("mamba", "mlstm", "slstm")
               for s in cfg.layer_specs())


def resolve_window(cfg: ArchConfig, spec: LayerSpec, seq_len: int) -> int:
    if spec.kind != "attn":
        return -1
    w = spec.window
    if (w <= 0 and seq_len >= cfg.long_context_threshold
            and not _arch_is_subquadratic(cfg)):
        w = cfg.long_context_window
    return w


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


_ENCODER_SPEC = LayerSpec(kind="attn", ffn="dense")


def _check_supported(spec: LayerSpec) -> None:
    if spec.kind not in ("attn", "mamba", "mlstm", "slstm"):
        raise NotImplementedError(f"{spec.kind} blocks are not ported")


def _init_layer(generator, cfg: ArchConfig, spec: LayerSpec, dtype) -> dict:
    _check_supported(spec)
    device = generator.device
    p = {"norm1": init_norm(cfg.norm, cfg.d_model, dtype, device)}
    if spec.kind == "attn":
        p["core"] = attn.init_attn(generator, cfg, spec, dtype)
    elif spec.kind == "mamba":
        p["core"] = mam.init_mamba(generator, cfg, dtype)
    elif spec.kind == "mlstm":
        p["core"] = xl.init_mlstm(generator, cfg, dtype)
    else:
        p["core"] = xl.init_slstm(generator, cfg, dtype)
    if spec.cross_attn:
        p["xnorm"] = init_norm(cfg.norm, cfg.d_model, dtype, device)
    if spec.ffn == "dense" and cfg.d_ff > 0:
        p["norm2"] = init_norm(cfg.norm, cfg.d_model, dtype, device)
        p["ffn"] = init_mlp(generator, cfg.d_model, cfg.d_ff, dtype)
    elif spec.ffn == "moe":
        p["norm2"] = init_norm(cfg.norm, cfg.d_model, dtype, device)
        p["ffn"] = moe_mod.init_moe(generator, cfg, dtype)
    return p


def init_params(generator: torch.Generator, cfg: ArchConfig) -> dict:
    """Weights drawn on ``generator`` and placed on its device, in the
    reference's tree and stacked stage layout.  Torch cannot reproduce
    JAX's PRNG bits: parity tests load JAX weights instead."""
    dtype = torch_dtype(cfg.param_dtype)
    params = {"embed": init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                      dtype, cfg.tie_embeddings),
              "final_norm": init_norm(cfg.norm, cfg.d_model, dtype,
                                      generator.device),
              "stages": []}
    for stage in cfg.stages:
        params["stages"].append(_stacked_draws(
            lambda: {f"l{j}": _init_layer(generator, cfg, spec, dtype)
                     for j, spec in enumerate(stage.pattern)},
            stage.repeats))
    if cfg.encoder is not None:
        params["encoder"] = _init_encoder(generator, cfg, dtype)
    return params


def _stacked_draws(draw, n: int) -> dict:
    """``n`` trees drawn by ``draw()`` one after another, stacked on a
    leading axis: each is written into its slot as it is drawn, so only
    the stack and one draw are held (a whole stage of qwen2-7b is 26 GB
    in float32); one draw is its own stack (views, no copy)."""
    first = draw()
    if n == 1:
        return tree_map(lambda a: a.unsqueeze(0), first)
    stacked = tree_map(lambda a: a.new_empty((n,) + tuple(a.shape)), first)
    tree_map(lambda s, a: s[0].copy_(a), stacked, first)
    del first
    for i in range(1, n):
        tree_map(lambda s, a: s[i].copy_(a), stacked, draw())
    return stacked


def _init_encoder(generator, cfg: ArchConfig, dtype) -> dict:
    """The encoder's attention layers with dense feed-forward layers,
    stacked on a leading axis as a stage's, and its final norm."""
    return {"layers": _stacked_draws(
                lambda: _init_layer(generator, cfg, _ENCODER_SPEC, dtype),
                cfg.encoder.n_layers),
            "final_norm": init_norm(cfg.norm, cfg.d_model, dtype,
                                    generator.device)}


# ---------------------------------------------------------------------------
# layer / stage forward
# ---------------------------------------------------------------------------


def _ffn(lp, x, cfg: ArchConfig, spec: LayerSpec,
         generous_capacity: bool = False):
    """The feed-forward sublayer.  Returns (x, the MoE layer's router
    losses, or None)."""
    if spec.ffn == "dense" and cfg.d_ff > 0:
        h3 = apply_norm(lp["norm2"], x, cfg.norm, cfg.norm_eps)
        y, _ = apply_mlp(lp["ffn"], h3, cfg.act,
                         torch_dtype(cfg.compute_dtype))
        return x + summed(y), None
    if spec.ffn == "moe":
        h3 = apply_norm(lp["norm2"], x, cfg.norm, cfg.norm_eps)
        y, maux = moe_mod.moe_forward(lp["ffn"], h3, cfg=cfg,
                                      generous_capacity=generous_capacity)
        return x + summed(y), maux["moe_aux"]
    return x, None


def _layer_forward(lp, x, *, cfg: ArchConfig, spec: LayerSpec, positions,
                   window: int, runtime: Runtime, mode: str = "train",
                   enc_out=None, causal: bool = True):
    """Full-sequence block (an encoder layer with ``causal=False``).
    Returns (x, cache, the MoE router losses or None)."""
    _check_supported(spec)
    h = apply_norm(lp["norm1"], x, cfg.norm, cfg.norm_eps)
    if spec.kind == "attn" and not causal:
        core, cache = _encoder_attn(lp["core"], h, cfg, positions, runtime)
    elif spec.kind == "attn":
        core, cache = attn.attn_forward(lp["core"], h, cfg=cfg, spec=spec,
                                        positions=positions, window=window,
                                        runtime=runtime)
    elif spec.kind == "mamba":
        core, cache = mam.mamba_forward(lp["core"], h, cfg=cfg,
                                        runtime=runtime)
    elif spec.kind == "mlstm":
        core, cache = xl.mlstm_forward(lp["core"], h, cfg=cfg,
                                       runtime=runtime)
    else:
        core, cache = xl.slstm_forward(lp["core"], h, cfg=cfg,
                                       runtime=runtime)
    x = x + summed(core)
    if spec.cross_attn and enc_out is not None:
        xk, xv = attn.cross_kv(lp["core"], enc_out, cfg=cfg)
        x = _cross(lp, x, xk, xv, cfg)
        cache = dict(cache, xk=xk, xv=xv)
    x, aux = _ffn(lp, x, cfg, spec, generous_capacity=(mode != "train"))
    return x, cache, aux


def _cross(lp, x, xk, xv, cfg: ArchConfig):
    """The cross-attention sublayer against the encoder's keys and
    values."""
    h2 = apply_norm(lp["xnorm"], x, cfg.norm, cfg.norm_eps)
    return x + summed(attn.cross_attn_forward(lp["core"], h2, xk, xv,
                                               cfg=cfg))


def _encoder_attn(params, h, cfg: ArchConfig, positions, runtime: Runtime):
    """An encoder layer's self-attention: RoPE without M-RoPE sections,
    then non-causal scores over the whole input (the dense path at
    whisper's 1,500 frames: the flash kernel takes causal attention only).
    Returns (out, {})."""
    compute = torch_dtype(cfg.compute_dtype)
    q, k, v = attn._project_qkv(params, h, cfg, compute)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    pos1d = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    out = attn.scaled_attention(q, k, v, pos1d, pos1d, causal=False,
                                window=-1, cap=cfg.attn_softcap,
                                runtime=runtime)
    out = merge_heads(out, h.shape[0], h.shape[1], cfg.q_dim)
    return (out.to(compute) @ params["wo"].to(compute)).to(h.dtype), {}


def _layer_decode(lp, x, cache, pos: int, *, cfg: ArchConfig,
                  spec: LayerSpec, window: int, runtime: Runtime):
    """One-token block against its cache.  Returns (x, new cache)."""
    _check_supported(spec)
    h = apply_norm(lp["norm1"], x, cfg.norm, cfg.norm_eps)
    if spec.kind == "attn":
        core, new_cache = attn.attn_decode(lp["core"], h, cache, pos,
                                           cfg=cfg, spec=spec, window=window,
                                           runtime=runtime)
    elif spec.kind == "mamba":
        core, new_cache = mam.mamba_decode(lp["core"], h, cache, cfg=cfg)
    elif spec.kind == "mlstm":
        core, new_cache = xl.mlstm_decode(lp["core"], h, cache, cfg=cfg)
    else:
        core, new_cache = xl.slstm_decode(lp["core"], h, cache, cfg=cfg)
    x = x + summed(core)
    if spec.cross_attn:
        x = _cross(lp, x, cache["xk"], cache["xv"], cfg)
        new_cache = dict(new_cache, xk=cache["xk"], xv=cache["xv"])
    # one token a row: a MoE layer's capacity is the generous one
    return _ffn(lp, x, cfg, spec)[0], new_cache


def _stage_forward(stage_params, x, *, cfg: ArchConfig, pattern, repeats,
                   positions, seq_len: int, runtime: Runtime,
                   collect_cache: bool = False, mode: str = "train",
                   enc_out=None):
    """The stage's periods in order.  Returns (x, aux, caches): aux the
    MoE layers' router losses added up in layer order, and with
    ``collect_cache`` each layer's cache stacked on the ``repeats`` axis,
    else an empty dict per layer.

    With ``runtime.remat``, a training forward (``mode="train"``) under
    autograd runs each period under ``torch.utils.checkpoint``
    (non-reentrant), as the reference wraps its scan body in
    ``jax.checkpoint``: only the period's input is kept, and the backward
    runs its forward again, the chunk checkpoints of the scans, the long
    attention paths and the cross-entropy nested inside.  The forward
    draws no random numbers, so no RNG state is saved.  Where no input
    tracks a gradient (``no_grad``, inference mode, inside
    ``torch.func.vmap``, whose batched inputs read ``requires_grad``
    False: a checkpoint's backward would recompute outside the vmap),
    every period runs as it is."""
    windows = [resolve_window(cfg, spec, seq_len) for spec in pattern]

    def period(x, aux, leaves):
        leaves = dtensor.fsdp_gathered(leaves, runtime)
        caches = {}
        for j, spec in enumerate(pattern):
            x, c, a = _layer_forward(leaves[f"l{j}"], x, cfg=cfg, spec=spec,
                                     positions=positions, window=windows[j],
                                     runtime=runtime, mode=mode,
                                     enc_out=enc_out)
            x = shard_batch(x, runtime)
            if a is not None:
                aux = aux + a
            caches[f"l{j}"] = c if collect_cache else {}
        return x, aux, caches

    remat = runtime.remat and mode == "train" and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    periods = []
    for i in range(repeats):
        leaves = tree_map(lambda a: a[i], stage_params)
        inputs = [x] + tree_leaves(leaves) + (
            [] if enc_out is None else [enc_out])
        if remat and any(t.requires_grad for t in inputs):
            x, aux, caches = checkpoint(period, x, aux, leaves,
                                        use_reentrant=False,
                                        preserve_rng_state=False)
        else:
            x, aux, caches = period(x, aux, leaves)
        periods.append(caches)
    return x, aux, tree_map(lambda *leaves: torch.stack(leaves), *periods)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device=None):
    """Zero decode cache mirroring the stage structure: one dict per
    stage, each layer's entry stacked on the stage's ``repeats`` axis."""
    caches = []
    for stage in cfg.stages:
        sc = {}
        lead = (stage.repeats,)
        for j, spec in enumerate(stage.pattern):
            _check_supported(spec)
            if spec.kind == "attn":
                c = attn.init_kv_cache(cfg, spec, batch, max_seq,
                                       leading=lead, device=device)
                if spec.cross_attn:
                    c["xk"] = torch.zeros(
                        lead + (batch, cfg.encoder.n_ctx, cfg.n_kv_heads,
                                cfg.head_dim),
                        dtype=torch_dtype(cfg.cache_dtype), device=device)
                    c["xv"] = torch.zeros_like(c["xk"])
            elif spec.kind == "mamba":
                c = mam.init_mamba_state(cfg, batch, leading=lead,
                                         device=device)
            elif spec.kind == "mlstm":
                c = xl.init_mlstm_state(cfg, batch, leading=lead,
                                        device=device)
            else:
                c = xl.init_slstm_state(cfg, batch, leading=lead,
                                        device=device)
            sc[f"l{j}"] = c
        caches.append(sc)
    return caches


def _embed(params, tokens, cfg: ArchConfig):
    x = embed_tokens(params["embed"], tokens, torch_dtype(cfg.compute_dtype))
    if cfg.norm == "rmsnorm" and cfg.tie_embeddings:
        x = x * cfg.d_model ** 0.5
    return x


def _positions_for(cfg: ArchConfig, batch, B: int, S: int, device):
    """The batch's positions, else 0..S-1 for every row: (B, S), or
    (3, B, S) for M-RoPE (a text stream's three ids alike)."""
    if batch.get("positions") is not None:
        return batch["positions"]
    pos = torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)
    if cfg.mrope_sections is not None:
        pos = pos[None].expand(3, B, S)
    return pos


def _encoder_forward(params, enc_embed, cfg: ArchConfig,
                     runtime: Runtime):
    """The encoder over ``enc_embed`` (B, S, d), cast to the compute
    type: its layers in order, then its final norm."""
    B, S = enc_embed.shape[:2]
    pos = torch.arange(S, dtype=torch.int32,
                       device=enc_embed.device)[None].expand(B, S)
    x = enc_embed.to(torch_dtype(cfg.compute_dtype))
    layers = params["encoder"]["layers"]
    for i in range(cfg.encoder.n_layers):
        x, _, _ = _layer_forward(dtensor.fsdp_gathered(
            tree_map(lambda a: a[i], layers), runtime), x,
                                 cfg=cfg, spec=_ENCODER_SPEC, positions=pos,
                                 window=-1, runtime=runtime, causal=False)
    return apply_norm(params["encoder"]["final_norm"], x, cfg.norm,
                      cfg.norm_eps)


def forward_hidden(params, batch, cfg: ArchConfig,
                   runtime: Runtime = DEFAULT, collect_cache: bool = False,
                   mode: str = "train"):
    """Full-sequence forward up to the final norm (no unembedding).

    Returns (h (B,S,d), aux dict), and with ``collect_cache`` the caches
    too: one dict per stage, each layer's cache stacked on the stage's
    ``repeats`` axis (``prefill``).  With ``cfg.encoder`` the encoder runs
    first, over ``batch["enc_embed"]``.  ``aux["moe_aux"]`` is the MoE layers'
    summed router losses (float32, 0 without MoE layers).  With
    ``runtime.want_signature``, ``aux["signature"]`` is the bucketed Eq. 3
    signature of ``h`` (``kernels.ops.signature``; on a DTensor mesh
    each chip counts its block, ``sharding.dtensor.row_counts``).
    """
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = shard_batch(_embed(params, tokens, cfg), runtime)
    positions = _positions_for(cfg, batch, B, S, tokens.device)
    enc_out = None
    if cfg.encoder is not None:
        enc_out = shard_batch(_encoder_forward(
            params, batch["enc_embed"], cfg, runtime), runtime)
    caches = []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, stage in enumerate(cfg.stages):
        x, stage_aux, cache = _stage_forward(
            params["stages"][si], x, cfg=cfg, pattern=stage.pattern,
            repeats=stage.repeats, positions=positions, seq_len=S,
            runtime=runtime, collect_cache=collect_cache, mode=mode,
            enc_out=enc_out)
        x = shard_batch(x, runtime)
        aux_total = aux_total + stage_aux
        caches.append(cache)
    x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    aux = {"moe_aux": aux_total}
    if runtime.want_signature:
        # counts have no gradient: the kernel takes the detached output
        counts, rows = dtensor.row_counts(
            lambda t: ops.signature_counts(t[None],
                                           runtime.signature_tau)[0],
            x.detach())
        aux["signature"] = ops.signature_of_counts(
            counts, rows, n_sig=runtime.signature_dims)
    if collect_cache:
        return x, aux, caches
    return x, aux


def per_sample_signature(h, runtime: Runtime = DEFAULT) -> torch.Tensor:
    """Per-sample Eq. 3 signature rows (B, n_sig) from the final-norm
    output ``h`` (B, S, d), for the cohort engine's padding-masked means:
    one launch of the signature kernel over ``h`` (the reference launches
    once per row under ``vmap``), the bits of the reference's rows."""
    return ops.signature_per_sample(h, tau=runtime.signature_tau,
                                    n_sig=runtime.signature_dims)


def forward(params, batch, cfg: ArchConfig, runtime: Runtime = DEFAULT,
            mode: str = "train"):
    """Full logits (B,S,V) float32, and aux."""
    h, aux = forward_hidden(params, batch, cfg, runtime, mode=mode)
    logits = unembed(params["embed"], h, torch_dtype(cfg.compute_dtype),
                     cfg.final_softcap)
    return logits, aux


def _ce_chunk(cfg: ArchConfig, B: int, S: int) -> int:
    """The reference's sequence chunk of the cross-entropy: float32 logits
    of about 32 GB or less over the whole batch, a power of two from 64 to
    1,024 that divides S (halved until it does, down to 1)."""
    c = int(32e9 / (4.0 * B * cfg.vocab_size))
    c = max(64, min(1024, 1 << (c.bit_length() - 1) if c > 0 else 64))
    while S % c:
        c //= 2
        if c < 1:
            return S
    return c


def _ce_part(embed, h, labels, mask, cfg: ArchConfig):
    """One sequence chunk's masked CE sum and mask count, float32: the
    unembedding, the logsumexp and the label's logit."""
    logits = unembed(embed, h, torch_dtype(cfg.compute_dtype),
                     cfg.final_softcap)
    if dtensor.vocab_sharded(logits):
        logz, ll = dtensor.vocab_sharded_ce(logits, labels)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return ((logz - ll) * mask).sum(), mask.sum()


def loss_fn(params, batch, cfg: ArchConfig, runtime: Runtime = DEFAULT):
    """Mean next-token cross-entropy over the (optionally masked) labels.

    As in the reference, the unembedding and the cross-entropy run per
    sequence chunk (``_ce_chunk``), each under ``torch.utils.checkpoint``
    under autograd where there are several, so the whole (B,S,V) float32
    logits never exist: at gemma3-27b's 262,144-token vocabulary they take
    4.3 GB a 4,096-token row before their gradient.  (One chunk's logits
    are held at the backward's peak either way, so a single chunk runs
    without the recompute.)  The loss is the masked sum over the count,
    ``tot / max(cnt, 1)``, plus the MoE layers' router losses."""
    h, aux = forward_hidden(params, batch, cfg, runtime)
    labels = batch["labels"]
    mask = batch.get("mask")
    mask = torch.ones(labels.shape, device=h.device) if mask is None \
        else mask.float()
    C = _ce_chunk(cfg, *h.shape[:2])
    track = torch.is_grad_enabled() and h.requires_grad and C < h.shape[1]
    tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    embed = dtensor.fsdp_gathered(params["embed"], runtime)   # not a chunk
    for c in range(0, h.shape[1], C):
        args = (embed, h[:, c:c + C], labels[:, c:c + C],
                mask[:, c:c + C], cfg)
        t, n = (checkpoint(_ce_part, *args, use_reentrant=False) if track
                else _ce_part(*args))
        tot, cnt = tot + t, cnt + n
    loss = tot / torch.clamp(cnt, min=1.0)
    aux = dict(aux)
    aux["ce_loss"] = loss
    return loss + aux["moe_aux"], aux


def prefill(params, batch, cfg: ArchConfig, runtime: Runtime = DEFAULT):
    """Serve-prefill: last-position logits (B, V) float32, the caches, and
    aux (the full (B,S,V) logits are never formed)."""
    h, aux, caches = forward_hidden(params, batch, cfg, runtime,
                                    collect_cache=True, mode="prefill")
    logits = unembed(params["embed"], h[:, -1:],
                     torch_dtype(cfg.compute_dtype), cfg.final_softcap)
    return logits[:, 0], caches, aux


def decode_step(params, token, caches, pos: int, cfg: ArchConfig,
                runtime: Runtime = DEFAULT):
    """One decode step.  token (B,1) integer, ``pos`` a Python int (the
    token's position).  Returns (logits (B,V) float32, caches): the
    caches given, updated in place (the attention layers' slot ``pos``
    written, the recurrent states replaced row by row of the stack)."""
    x = shard_batch(_embed(params, token, cfg), runtime)
    for si, stage in enumerate(cfg.stages):
        cache_seq = _cache_seq_len(caches[si], stage.pattern, cfg)
        windows = [resolve_window(cfg, spec, cache_seq)
                   for spec in stage.pattern]
        for i in range(stage.repeats):
            for j, spec in enumerate(stage.pattern):
                lp = dtensor.fsdp_gathered(tree_map(
                    lambda a: a[i], params["stages"][si][f"l{j}"]), runtime)
                stacked = caches[si][f"l{j}"]
                cache = {k: v[i] for k, v in stacked.items()}
                x, new = _layer_decode(lp, x, cache, pos, cfg=cfg, spec=spec,
                                       window=windows[j], runtime=runtime)
                for k, v in new.items():
                    if v is not cache[k]:
                        stacked[k][i].copy_(v)
    x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    logits = unembed(params["embed"], x, torch_dtype(cfg.compute_dtype),
                     cfg.final_softcap)
    return logits[:, 0], caches


def _cache_seq_len(stage_cache, pattern, cfg: ArchConfig) -> int:
    """The sequence length a stage's attention caches were built for (0
    for a stage without attention)."""
    key = "ckv" if cfg.mla is not None else "k"
    for j, spec in enumerate(pattern):
        if spec.kind == "attn":
            return stage_cache[f"l{j}"][key].shape[2]
    return 0
