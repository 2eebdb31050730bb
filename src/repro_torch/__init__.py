"""PyTorch/CUDA port of the ``repro`` federated-learning package.

Module paths mirror ``repro``'s, so ``repro_torch/core/pipeline.py`` is the
counterpart of ``repro/core/pipeline.py``.  Parameters are ``dict[str,
Tensor]`` in the reference layouts (conv weights HWIO, dense ``[in, out]``)
and are walked in the order ``jax.tree`` uses (``repro_torch.pytree``), so
blocks, scales and top-k thresholds fall on the same elements; the LM
zoo's params are nested dicts with the reference's leaf names and
layer-stacked ``[G, ...]`` groups, and train as their flat view, one
``/``-joined path per leaf.  The kernels (the commit path's and the
selective scan) are CUDA C++ for Hopper (``kernels/csrc``); a CPU tensor
takes each kernel's plain PyTorch version, a CUDA tensor launches the
kernel.
"""
