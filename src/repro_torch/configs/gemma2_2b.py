"""gemma2-2b — Gemma-2 2B [arXiv:2408.00118].

26L, d_model=2304, 8 q-heads / 4 kv-heads, head_dim=256 (q dim 2048 != d_model
— gemma allows that), d_ff=9216 (GeGLU), vocab 256000. Alternating
local(sliding-window 4096)/global attention, attn-logit softcap 50, final
logit softcap 30, query scale 1/sqrt(256), post-block norms, embeddings
scaled by sqrt(d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    local_global_alternate=True,
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    query_pre_attn_scalar=256.0,
    post_norm=True,
    embed_scale=48.0,           # sqrt(2304)
    act="gelu",
    tie_embeddings=True,
    norm_eps=1e-6,
    scan_period=2,              # (local, global) pairs
)
