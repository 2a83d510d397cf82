"""Flash attention, forward and backward: the CUDA kernels
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``), their
launchers (``flash.py``), their plain versions (``ref.py``) and the public
wrapper with its ``autograd.Function`` (``ops.py``)."""
