"""PyTorch/CUDA port of the ``repro`` federated-learning package.

Module paths mirror ``repro``'s, so ``repro_torch/core/pipeline.py`` is the
counterpart of ``repro/core/pipeline.py``.  Parameters are ``dict[str,
Tensor]`` in the reference layouts (conv weights HWIO, dense ``[in, out]``)
and are flattened in sorted-key order, the order ``jax.tree`` uses, so
blocks, scales and top-k thresholds fall on the same elements; the LM
zoo's params are nested dicts with the reference's leaf names and
layer-stacked ``[G, ...]`` groups.  The kernels (the commit path's and the
selective scan) are CUDA C++ for Hopper (``kernels/csrc``); a CPU tensor
takes each kernel's plain PyTorch version, a CUDA tensor launches the
kernel.
"""
