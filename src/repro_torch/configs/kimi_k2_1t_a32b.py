"""Kimi K2: trillion-parameter MoE, 384 experts top-8, 32B active.

[arXiv:2501.kimi2 (paper-table)] — 61L, d_model=7168, per-expert FFN 2048.
"""
from repro_torch.configs.base import MoEConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    kv_heads=8,
    d_ff=2048,
    vocab=163840,
    head_dim=112,
    act="swiglu",
    moe=MoEConfig(num_experts=384, top_k=8, d_expert=2048, every=1),
    source="arXiv:2501.kimi2 (Kimi K2, paper-table)",
))
