"""Hand-written CUDA kernels of the commit path, their plain PyTorch
versions (``ref``) and their entry points (``ops``)."""
