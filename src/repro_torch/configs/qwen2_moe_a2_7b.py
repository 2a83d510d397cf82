"""qwen2-moe-a2.7b — Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L, d_model=2048, 16 heads MHA-ish (kv=16), head_dim=128, vocab 151936.
Every layer is MoE: 60 routed experts (per-expert d_ff=1408, top-4) plus a
shared expert of d_ff 5632 (~= 4 merged shared experts, as released).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=0,                      # no dense FFN layers — MoE everywhere
    vocab_size=151_936,
    num_experts=60,
    experts_per_token=4,
    moe_d_ff=1408,
    num_shared_experts=4,
    shared_d_ff=5632,
    moe_every=1,
    tie_embeddings=False,
    norm_eps=1e-6,
    scan_period=1,
)
