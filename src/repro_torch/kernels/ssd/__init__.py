"""Mamba-2 SSD intra-chunk kernel: the CUDA kernel (``csrc/ssd_chunk.cu``),
its launcher (``chunk_kernel.py``), its plain versions (``ref.py``) and the
public wrapper (``ops.py``)."""
