"""minicpm-2b — MiniCPM 2.4B, llama-like with mup-style scaling + WSD
schedule [arXiv:2404.06395].

40L, d_model=2304, 36 heads MHA (kv=36), head_dim=64, d_ff=5760, vocab
122753. Depth-scaled residuals (1.4/sqrt(L)) and scaled embeddings (12x).
The WSD (warmup-stable-decay) schedule lives in repro_torch.train.optimizer
and is selected by this config's name.
"""
import math

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122_753,
    residual_scale=1.4 / math.sqrt(40),
    embed_scale=12.0,
    tie_embeddings=True,
    norm_eps=1e-5,
    scan_period=1,
)
