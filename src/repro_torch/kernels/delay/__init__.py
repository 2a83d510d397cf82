"""The §4.1 delay chain kernel: the CUDA kernel (``csrc/delay_chain.cu``),
its launcher (``delay.py``), its plain version (``ref.py``) and the public
wrapper (``ops.py``)."""
