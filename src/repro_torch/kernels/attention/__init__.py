"""Flash attention forward: the CUDA kernel (``csrc/flash_attention.cu``),
its launcher (``flash.py``), its plain versions (``ref.py``) and the
public wrapper (``ops.py``)."""
