"""The paper's own experiment models (§5.2): a CIFAR-10-scale CNN, a
Shakespeare-scale character LM, and a MedMNIST-scale classifier.

These are what Tables 2-4 are produced with; they are registered here so
the FL framework treats them as first-class architectures alongside the
assigned large archs.
"""
from repro_torch.configs.base import ModelConfig, register

# Character-level LM used for the Shakespeare (LEAF) task.
CHARLM = register(ModelConfig(
    name="paper-charlm",
    family="dense",
    n_layers=4,
    d_model=256,
    n_heads=4,
    kv_heads=4,
    d_ff=1024,
    vocab=128,
    act="gelu",
    dtype="float32",
    source="paper §5.2 (Shakespeare/LEAF char-LM)",
))
