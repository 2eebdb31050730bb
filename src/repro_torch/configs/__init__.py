"""Architecture + input-shape registry.

Each ``<arch>.py`` module registers one assigned architecture (with citation).
``INPUT_SHAPES`` defines the assigned workload shapes.
"""
from repro_torch.configs.base import (  # noqa: F401
    MambaConfig, MoEConfig, ModelConfig, XLSTMConfig,
    get_config, list_archs, reduced, register,
)

# Input shapes assigned to this paper -----------------------------------------
from dataclasses import dataclass


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}

# Import side effects register every architecture.
from repro_torch.configs import (  # noqa: F401, E402
    jamba_1_5_large_398b,
    xlstm_125m,
    mistral_large_123b,
    starcoder2_7b,
    gemma_2b,
    kimi_k2_1t_a32b,
    granite_3_2b,
    musicgen_medium,
    llama_3_2_vision_90b,
    qwen3_moe_235b_a22b,
    paper_models,
)

ASSIGNED_ARCHS = [
    "jamba-1.5-large-398b",
    "xlstm-125m",
    "mistral-large-123b",
    "starcoder2-7b",
    "gemma-2b",
    "kimi-k2-1t-a32b",
    "granite-3-2b",
    "musicgen-medium",
    "llama-3.2-vision-90b",
    "qwen3-moe-235b-a22b",
]
