"""whisper-large-v3 — encoder-decoder speech model backbone
[arXiv:2212.04356].

32 encoder + 32 decoder layers, d_model=1280, 20 heads (kv=20, MHA),
head_dim=64, d_ff=5120 (GELU), vocab 51866. Conv audio frontend is a STUB:
``input_specs()`` provides 1500 precomputed post-conv frame embeddings.
Learned positional embeddings, LayerNorm (not RMSNorm), untied... Whisper
ties decoder token embedding and unembedding -> tie_embeddings=True.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,              # decoder layers
    encoder_layers=32,
    is_encoder_decoder=True,
    encoder_seq=1500,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51_866,
    frontend="audio_frames",
    frontend_dim=1280,
    pos_embedding="learned",
    act="gelu",
    norm_type="layernorm",
    tie_embeddings=True,
    norm_eps=1e-5,
    scan_period=1,
)
