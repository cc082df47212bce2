"""xlstm-125m — sLSTM + mLSTM recurrent blocks, attention-free
[arXiv:2405.04517].

d_ff = 0: xLSTM blocks carry their own up/down projections, there is no
separate FFN sublayer.  Pattern [mLSTM x3, sLSTM] x3 approximates the paper's
mLSTM-heavy [m:s = 7:1]-style interleave at 12 layers.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, Stage, XLSTMConfig

_M = LayerSpec(kind="mlstm", ffn="none")
_S = LayerSpec(kind="slstm", ffn="none")

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    citation="arXiv:2405.04517 (xLSTM)",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    stages=(Stage((_M, _M, _M, _S), 3),),
    use_rope=False,
    xlstm=XLSTMConfig(m_qk_dim_factor=0.5, m_expand=2, s_conv=4, chunk=256),
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
)
