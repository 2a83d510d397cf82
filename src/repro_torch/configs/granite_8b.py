"""granite-8b — IBM Granite 8B code model, llama-architecture
[arXiv:2405.04324].

36L, d_model=4096, 32 q-heads / 8 kv-heads (GQA), head_dim=128, d_ff=14336,
vocab 49152 (StarCoder tokenizer), tied embeddings, rope theta 10M.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=49_152,
    rope_theta=10_000_000.0,
    tie_embeddings=True,
    norm_eps=1e-5,
    scan_period=1,
)
