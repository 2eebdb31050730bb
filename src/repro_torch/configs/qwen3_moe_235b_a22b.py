"""Qwen3-MoE-235B-A22B: 128 experts top-8.

[hf:Qwen/Qwen3-30B-A3B (235B-A22B scale)] — 94L, d_model=4096,
per-expert FFN 1536.
"""
from repro_torch.configs.base import MoEConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    kv_heads=4,
    d_ff=1536,
    vocab=151936,
    head_dim=64,
    act="swiglu",
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_expert=1536, every=1),
    source="hf:Qwen/Qwen3-30B-A3B (235B-A22B)",
))
