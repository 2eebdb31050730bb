"""StarCoder2-7B: dense, GQA kv=4, native sliding-window 4096, RoPE.

[arXiv:2402.19173]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    kv_heads=4,
    d_ff=18432,
    vocab=49152,
    head_dim=128,
    act="gelu",
    sliding_window=4096,
    rope_theta=100_000.0,
    source="arXiv:2402.19173 (StarCoder2)",
))
