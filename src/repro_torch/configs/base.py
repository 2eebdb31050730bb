"""Architecture configuration system, a copy of ``repro/configs/base.py``
(pure data, so ``get_config``/``reduced`` give the same objects in both
packages).

Every assigned architecture is expressed as a :class:`ModelConfig`; the model
zoo (``repro_torch.models``) consumes these declaratively.  Each config file
under ``repro_torch/configs/`` exports a ``CONFIG`` object and cites its
source in ``source``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # hidden dim of each expert FFN
    every: int = 1                # MoE replaces the FFN every Nth layer
    capacity_factor: float = 1.25
    load_balance_coef: float = 0.01


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 -> ceil(d_model / 16)
    chunk: int = 128              # chunked selective-scan chunk length


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 2          # sLSTM block every Nth block; rest mLSTM
    proj_factor: float = 2.0      # mLSTM up-projection factor
    chunk: int = 64               # mLSTM chunkwise-parallel chunk length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int                     # dense FFN hidden (for MoE archs: see moe.d_expert)
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    act: str = "swiglu"           # swiglu | geglu | gelu
    rope_theta: float = 10_000.0
    sliding_window: int = 0       # 0 -> full causal attention
    attn_every: int = 0           # hybrid: attention layer every Nth layer (rest Mamba)
    cross_attn_every: int = 0     # vlm: cross-attention layer every Nth layer
    n_patches: int = 576          # vlm stub: number of image patch embeddings
    n_codebooks: int = 0          # audio: EnCodec codebooks (parallel heads)
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    source: str = ""

    # ---- derived -----------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Vocab padded up to a multiple of 256 so logits shard over `model`."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def is_decoder(self) -> bool:
        return True  # all assigned archs are decoder LMs

    def supports_long_context(self) -> bool:
        """Sub-quadratic decode path exists (SSM/hybrid state or sliding window)."""
        return (
            self.family in ("ssm", "hybrid")
            or self.xlstm is not None
            or self.mamba is not None and self.attn_every == 0
            or self.sliding_window > 0
        )

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 256,
            seq_friendly: bool = True) -> ModelConfig:
    """Reduced variant of the same family for CPU smoke tests.

    Keeps the structural features (GQA ratio, MoE, hybrid interleave,
    cross-attn, codebooks) while shrinking every dimension.
    """
    n_heads = max(2, min(cfg.n_heads, 4))
    kv = max(1, min(cfg.kv_heads, n_heads))
    while n_heads % kv:
        kv -= 1
    head_dim = d_model // n_heads
    kw = dict(
        name=cfg.name + "-reduced",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        kv_heads=kv,
        head_dim=head_dim,
        d_ff=2 * d_model if cfg.d_ff else 0,
        vocab=min(cfg.vocab, 512),
        n_patches=16 if cfg.cross_attn_every else cfg.n_patches,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        dtype="float32",
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            num_experts=4, top_k=min(2, cfg.moe.top_k), d_expert=2 * d_model,
            every=min(cfg.moe.every, n_layers),
            capacity_factor=2.0,  # tiny token counts need slack
            load_balance_coef=cfg.moe.load_balance_coef,
        )
    if cfg.mamba is not None:
        kw["mamba"] = MambaConfig(d_state=8, d_conv=4, expand=2, chunk=16)
    if cfg.xlstm is not None:
        kw["xlstm"] = XLSTMConfig(slstm_every=2, proj_factor=2.0, chunk=8)
    if cfg.attn_every:
        kw["attn_every"] = min(cfg.attn_every, n_layers)
    if cfg.cross_attn_every:
        kw["cross_attn_every"] = min(cfg.cross_attn_every, n_layers)
    return cfg.replace(**kw)


# ---------------------------------------------------------------------------
_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # populate registry lazily
    from repro_torch import configs as _c  # noqa: F401  (triggers submodule imports)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    from repro_torch import configs as _c  # noqa: F401
    return sorted(_REGISTRY)
