"""llava-next-34b — VLM backbone (Yi-34B-class decoder) with anyres vision
patch frontend STUB [hf:llava-hf/llava-v1.6; backbone dims per assignment].

60L, d_model=7168, 56 q-heads / 8 kv-heads (GQA), head_dim=128, d_ff=20480,
vocab 64000. The vision tower is a stub: ``input_specs()`` provides
precomputed anyres patch embeddings already projected to d_model.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20_480,
    vocab_size=64_000,
    frontend="vision_patches",
    frontend_dim=7168,
    rope_theta=5_000_000.0,
    tie_embeddings=False,
    norm_eps=1e-5,
    param_dtype="bfloat16",
    scan_period=1,
)
