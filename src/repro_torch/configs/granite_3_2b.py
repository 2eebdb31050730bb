"""Granite-3.0-2B: dense, GQA kv=8.

[hf:ibm-granite/granite-3.0-2b-base] — note vocab 49155 is not a multiple
of 256; logits are padded to vocab_padded for `model`-axis sharding.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    kv_heads=8,
    d_ff=8192,
    vocab=49155,
    act="swiglu",
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base",
))
