"""mamba2-780m — pure Mamba-2 (SSD) LM, attention-free [arXiv:2405.21060].

48L, d_model=1536, expand=2 -> d_inner=3072, ssd head_dim=64 -> 48 ssm heads,
state N=128, vocab 50280 (GPT-NeoX tokenizer). No attention, no FFN sublayer
(the Mamba block subsumes both).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_chunk=256,
    pos_embedding="none",
    tie_embeddings=True,
    norm_eps=1e-5,
    scan_period=1,
)
