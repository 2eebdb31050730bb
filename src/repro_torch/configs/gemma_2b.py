"""Gemma-2B: dense, MQA (kv=1), GeGLU, head_dim=256, 256k vocab.

[arXiv:2403.08295]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    kv_heads=1,
    d_ff=16384,
    vocab=256000,
    head_dim=256,
    act="geglu",
    tie_embeddings=True,
    source="arXiv:2403.08295 (Gemma)",
))
