"""MusicGen-medium: decoder-only LM over EnCodec tokens (4 codebooks).

[arXiv:2306.05284] — the EnCodec audio codec (conv encoder/decoder) is the
stubbed modality frontend; this model consumes/predicts the 4 parallel
codebook token streams (vocab 2048 each) with summed codebook embeddings
and 4 parallel LM heads, as in the paper's "delay" interleaving.
MHA (kv_heads == n_heads == 24).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    kv_heads=24,
    d_ff=6144,
    vocab=2048,
    act="gelu",
    n_codebooks=4,
    source="arXiv:2306.05284 (MusicGen)",
))
