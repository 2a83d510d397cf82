"""granite-moe-1b-a400m — IBM Granite 3.0 1B-A400M MoE base
[hf:ibm-granite/granite-3.0-1b-a400m-base].

24L, d_model=1024, 16 q-heads / 8 kv-heads, head_dim=64, vocab 49155.
Every layer MoE: 32 experts, per-expert d_ff=512, top-8, no shared expert.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=0,
    vocab_size=49_155,
    num_experts=32,
    experts_per_token=8,
    moe_d_ff=512,
    moe_every=1,
    tie_embeddings=True,
    norm_eps=1e-6,
    scan_period=1,
)
