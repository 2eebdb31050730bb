"""Llama-3.2-Vision-90B: dense decoder with gated cross-attention image
layers every 5th layer.

[hf:meta-llama/Llama-3.2-11B-Vision (90B scale-up)] — the ViT vision
encoder + projector is the stubbed modality frontend; input_specs provides
projected patch embeddings [B, n_patches, d_model].
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    kv_heads=8,
    d_ff=28672,
    vocab=128256,
    head_dim=128,
    act="swiglu",
    rope_theta=500_000.0,
    cross_attn_every=5,
    n_patches=1601,
    source="hf:meta-llama/Llama-3.2-11B-Vision (90B)",
))
