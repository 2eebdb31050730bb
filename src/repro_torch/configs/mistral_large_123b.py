"""Mistral-Large-2 (123B dense, GQA kv=8).

[hf:mistralai/Mistral-Large-Instruct-2407].  sliding_window=4096 is a
*variant we enable* (Mistral-7B lineage uses SWA-4096) so that the dense
arch qualifies for the long_500k sub-quadratic decode shape; recorded in
DESIGN.md §Arch-applicability.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    kv_heads=8,
    d_ff=28672,
    vocab=32768,
    head_dim=128,
    act="swiglu",
    sliding_window=4096,
    rope_theta=1_000_000.0,
    source="hf:mistralai/Mistral-Large-Instruct-2407 (+SWA variant)",
))
