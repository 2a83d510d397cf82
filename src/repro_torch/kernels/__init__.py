"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (``ref.py``) and its public wrapper (``ops.py``)."""
