"""xLSTM-125M: alternating sLSTM + mLSTM blocks, no separate FFN.

[arXiv:2405.04517] — 12 blocks, d_model=768, 4 heads.  d_ff=0 per the
assignment (xLSTM blocks carry their own up/down projections).
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    kv_heads=4,
    d_ff=0,
    vocab=50304,
    xlstm=XLSTMConfig(slstm_every=2, proj_factor=2.0, chunk=64),
    dtype="bfloat16",
    source="arXiv:2405.04517 (xLSTM)",
))
