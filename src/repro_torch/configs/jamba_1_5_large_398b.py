"""Jamba-1.5-Large: hybrid Mamba+attention (1:7) with MoE (16e top-2).

[arXiv:2403.19887] — 398B total params.  Attention layer every 8th layer
(the other 7 are Mamba blocks); MoE replaces the FFN every 2nd layer.
"""
from repro_torch.configs.base import MambaConfig, MoEConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    kv_heads=8,
    d_ff=24576,
    vocab=65536,
    head_dim=128,
    act="swiglu",
    attn_every=8,                 # 1 attention : 7 mamba
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=24576, every=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, chunk=128),
    source="arXiv:2403.19887 (Jamba-1.5)",
))
