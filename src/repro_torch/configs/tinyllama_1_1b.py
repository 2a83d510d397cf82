"""tinyllama-1.1b — TinyLlama 1.1B, llama2 architecture [arXiv:2401.02385].

22L, d_model=2048, 32 q-heads / 4 kv-heads, head_dim=64, d_ff=5632,
vocab 32000, untied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab_size=32_000,
    tie_embeddings=False,
    norm_eps=1e-5,
    scan_period=1,
)
