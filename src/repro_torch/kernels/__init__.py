"""Hand-written CUDA kernels of the commit path and of the Mamba mixer's
selective scan, their plain PyTorch versions (``ref``) and their entry
points (``ops``)."""
