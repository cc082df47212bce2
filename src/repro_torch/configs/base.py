"""Architecture configuration dataclasses (port of ``repro.configs.base``).

An ``ArchConfig`` describes a model as a sequence of *stages*; each stage is a
repeating ``pattern`` of :class:`LayerSpec` blocks, repeated ``repeats``
times over parameters stacked along a leading ``repeats`` axis, so a JAX
parameter tree loads into the port unchanged.  Copied as it is, without the
assigned input-shape table of the TPU dry runs.  The port's transformer runs
the dense GQA families, Jamba's Mamba and attention blocks, xLSTM's mLSTM
and sLSTM blocks, and dense and mixture-of-experts feed-forward layers;
the other blocks' configs are kept so that :func:`reduced` and the
registry read every config.  ``param_count()`` is the reference's, miscounts and all (Mamba
and xLSTM layers, norms): the port counts its trees leaf by leaf.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Layer-level specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN settings (GSPMD-style capacity dispatch)."""

    n_experts: int
    top_k: int
    d_expert: int                 # per-expert hidden width
    n_shared: int = 0             # always-on shared experts (DeepSeek-V2)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01   # load-balance aux loss weight
    router_z_weight: float = 1e-3     # router z-loss weight


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434)."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 => full-rank q projection
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MambaConfig:
    """Mamba-1 selective SSM block (used by jamba)."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 => ceil(d_model/16)
    chunk: int = 256              # scan chunk for remat / Pallas kernel


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block settings (arXiv:2405.04517)."""

    # mLSTM: matrix-memory, parallel/chunkwise trainable
    m_qk_dim_factor: float = 0.5  # qk dim = factor * d_inner
    m_expand: int = 2
    # sLSTM: scalar-memory, strictly recurrent, post-up projection
    s_expand: int = 1
    s_conv: int = 4               # causal conv window preceding sLSTM
    chunk: int = 256


@dataclass(frozen=True)
class LayerSpec:
    """One block inside a stage pattern."""

    kind: str = "attn"            # attn | mamba | mlstm | slstm
    window: int = -1              # -1 => full causal attention; >0 sliding
    ffn: str = "dense"            # dense | moe | none
    cross_attn: bool = False      # decoder cross-attention (whisper)


@dataclass(frozen=True)
class Stage:
    pattern: Tuple[LayerSpec, ...]
    repeats: int


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EncoderConfig:
    """Audio/vision encoder backbone (frontend itself is stubbed)."""

    n_layers: int
    n_ctx: int                    # number of frame/patch embeddings
    causal: bool = False


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    citation: str

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    stages: Tuple[Stage, ...] = ()

    # attention details
    use_rope: bool = True         # jamba uses no positional encoding
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    qkv_bias: bool = False
    attn_softcap: float = 0.0     # gemma2 attention logit soft-cap
    final_softcap: float = 0.0    # gemma2 final logit soft-cap
    mla: Optional[MLAConfig] = None

    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    encoder: Optional[EncoderConfig] = None

    norm: str = "rmsnorm"         # rmsnorm | layernorm
    act: str = "silu"             # silu | gelu
    tie_embeddings: bool = True
    norm_eps: float = 1e-6

    # long-context adaptation: window applied to full-attention layers when
    # the requested sequence length exceeds ``long_context_threshold``.
    long_context_window: int = 8192
    long_context_threshold: int = 131072

    # dtype policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    moment_dtype: str = "float32"   # AdamW first/second-moment dtype
    cache_dtype: str = "bfloat16"   # KV-cache storage dtype

    def __post_init__(self):
        n = sum(len(s.pattern) * s.repeats for s in self.stages)
        if self.stages and n != self.n_layers:
            raise ValueError(
                f"{self.name}: stages describe {n} layers, expected {self.n_layers}")

    # -- derived quantities -------------------------------------------------

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def layer_specs(self):
        """Flat list of LayerSpec in execution order."""
        out = []
        for st in self.stages:
            for _ in range(st.repeats):
                out.extend(st.pattern)
        return out

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + per-layer)."""
        d = self.d_model
        total = self.vocab_size * d
        if not self.tie_embeddings:
            total += self.vocab_size * d
        for spec in self.layer_specs():
            if spec.kind == "attn":
                if self.mla is not None:
                    m = self.mla
                    qd = self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
                    total += d * qd                           # q proj
                    total += d * (m.kv_lora_rank + m.qk_rope_dim)  # kv down
                    total += m.kv_lora_rank * self.n_heads * (
                        m.qk_nope_dim + m.v_head_dim)         # kv up
                    total += self.n_heads * m.v_head_dim * d  # o proj
                else:
                    total += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                if spec.cross_attn:
                    total += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            elif spec.kind == "mamba":
                mc = self.mamba or MambaConfig()
                d_in = mc.expand * d
                dt_rank = mc.dt_rank or -(-d // 16)
                total += d * 2 * d_in + d_in * mc.d_conv
                total += d_in * (dt_rank + 2 * mc.d_state) + dt_rank * d_in
                total += d_in * d + 2 * d_in * mc.d_state
            elif spec.kind == "mlstm":
                xc = self.xlstm or XLSTMConfig()
                d_in = xc.m_expand * d
                qk = int(xc.m_qk_dim_factor * d_in)
                total += d * 2 * d_in + d_in * (2 * qk + d_in) + d_in * d
            elif spec.kind == "slstm":
                xc = self.xlstm or XLSTMConfig()
                total += 4 * d * d + 4 * d * d // 4 + int(4.0 / 3 * d * d) * 2
            if spec.ffn == "dense" and self.d_ff > 0:
                total += 3 * d * self.d_ff
            elif spec.ffn == "moe" and self.moe is not None:
                mo = self.moe
                total += d * mo.n_experts
                total += 3 * d * mo.d_expert * (mo.n_experts + mo.n_shared)
        if self.encoder is not None:
            e = self.encoder
            per = 4 * d * d + 3 * d * self.d_ff if self.d_ff else 4 * d * d
            total += e.n_layers * per
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE counts top_k + shared experts)."""
        if self.moe is None:
            return self.param_count()
        total = self.param_count()
        mo = self.moe
        n_moe_layers = sum(1 for s in self.layer_specs() if s.ffn == "moe")
        inactive = max(mo.n_experts - mo.top_k, 0)
        total -= n_moe_layers * 3 * self.d_model * mo.d_expert * inactive
        return total


# ---------------------------------------------------------------------------
# Input shapes (the reference's, for the dry run)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                     # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: ArchConfig, d_model: int = 256, max_experts: int = 4) -> ArchConfig:
    """Reduced smoke-test variant of the same family: 2 layers, small dims."""
    pattern = cfg.stages[-1].pattern if cfg.stages else (LayerSpec(),)
    pattern = pattern[: min(len(pattern), 2)]
    repeats = -(-2 // len(pattern))  # >= 2 layers total
    n_layers = len(pattern) * repeats
    n_heads = min(cfg.n_heads, 4)
    head_dim = max(d_model // n_heads, 16)
    n_kv = min(cfg.n_kv_heads, n_heads)
    while n_heads % n_kv:
        n_kv -= 1
    if cfg.n_kv_heads < cfg.n_heads and n_kv == n_heads:
        n_kv = max(n_heads // 2, 1)   # preserve GQA in the reduced family
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe, n_experts=min(cfg.moe.n_experts, max_experts),
            top_k=min(cfg.moe.top_k, 2), d_expert=d_model,
            n_shared=min(cfg.moe.n_shared, 1))
    mla = None
    if cfg.mla is not None:
        mla = MLAConfig(kv_lora_rank=64, qk_nope_dim=head_dim,
                        qk_rope_dim=32, v_head_dim=head_dim)
    enc = None
    if cfg.encoder is not None:
        enc = EncoderConfig(n_layers=2, n_ctx=16, causal=cfg.encoder.causal)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=0 if cfg.d_ff == 0 else d_model * 2,
        vocab_size=512,
        stages=(Stage(pattern, repeats),),
        moe=moe,
        mla=mla,
        encoder=enc,
        mamba=MambaConfig(d_state=8, chunk=32) if cfg.mamba else None,
        xlstm=XLSTMConfig(chunk=32) if cfg.xlstm else None,
        long_context_threshold=cfg.long_context_threshold,
        # CPU test configs run everything in f32 (the CPU backend cannot
        # execute bf16 dots; TPU-targeted full configs keep bf16)
        param_dtype="float32",
        compute_dtype="float32",
        cache_dtype="float32",
    )
