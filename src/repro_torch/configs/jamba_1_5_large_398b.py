"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave with MoE
[arXiv:2403.19887 / Jamba-1.5].

72L, d_model=8192, attention every 8th layer (9 attn / 63 mamba),
MoE (16 experts, top-2) every 2nd layer, dense FFN otherwise.
64 q-heads / 8 kv-heads, head_dim=128, d_ff=24576, vocab 65536.
Attention layers carry no positional embedding (Mamba layers provide
position), as in Jamba.

Adaptation note (the reference's): Jamba uses Mamba-1 selective-scan
mixers; the model uses Mamba-2 SSD blocks (state=128) so the hybrid shares
the SSD intra-chunk kernel (``kernels/ssd``) — same state-space role, a
formulation made of matrix products.

Param audit: MoE 36L*16e*3*8192*24576 = 348.5B, dense FFN 36L = 21.8B,
mamba 63L*~0.41B = 25.6B, attn 9L*0.15B = 1.4B, embeds 1.1B -> ~398B total;
active ~94B (top-2). Matches the published 398B/94B split.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24_576,
    vocab_size=65_536,
    num_experts=16,
    experts_per_token=2,
    moe_d_ff=24_576,
    moe_every=2,
    attn_every=8,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=128,
    ssm_conv_width=4,
    ssm_chunk=256,
    pos_embedding="none",
    tie_embeddings=False,
    norm_eps=1e-6,
    param_dtype="bfloat16",
    scan_period=8,
)
