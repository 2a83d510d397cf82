"""Configurations: the port's own copies of ``repro.configs.base``'s
``GAConfig``, ``ModelConfig`` and the input-shape cells (``ShapeConfig``,
``SHAPES``, ``shape_applicable``).

Field names, defaults and derived values are those of the reference, so one
set of keyword arguments builds the same configuration in both packages:
``GAConfig`` (``global_pop``, ``indpb``, ``bounds()``) for the GA, and
``ModelConfig`` (``padded_vocab``, ``d_inner``, ``ssm_heads``,
``mixer_kind``, ``ffn_kind``, ``is_local_layer``, ``reduced()``,
``total_params()``) for the LM architectures.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class GAConfig:
    """NSGA-II island-model settings (paper Tab. 3 / §4)."""

    num_genes: int
    pop_per_island: int = 64        # P
    num_islands: int = 4            # I
    num_objectives: int = 1
    generations_per_epoch: int = 5  # M (migration period)
    num_epochs: int = 10            # N_E
    # variation operators (paper: polynomial mutation + SBX crossover)
    mutation_prob: float = 0.7      # mu_mut
    mutation_eta: float = 34.6      # eta_mut (distribution index)
    crossover_prob: float = 1.0     # mu_cx
    crossover_eta: float = 97.5     # eta_cx
    tournament_size: int = 2
    # migration
    migration_pattern: str = "ring"
    num_migrants: int = 1           # paper: best individual migrates
    # bounds (scalar, or per-gene tuples of length num_genes)
    lower: float = -1.0
    upper: float = 1.0
    gene_lower: Optional[Tuple[float, ...]] = None
    gene_upper: Optional[Tuple[float, ...]] = None
    # per-gene mutation probability inside a mutating individual (DEAP
    # indpb); 0.0 -> 1/num_genes
    mutation_indpb: float = 0.0
    # engine
    seed: int = 0
    elitism: bool = True            # NSGA-II (mu+lambda) survivor selection
    fused_operators: bool = True    # use the fused variation CUDA kernel

    @property
    def global_pop(self) -> int:
        return self.pop_per_island * self.num_islands

    @property
    def indpb(self) -> float:
        return self.mutation_indpb or 1.0 / self.num_genes

    def bounds(self):
        """(lower, upper) as (G,) float32 numpy arrays."""
        lo = (np.asarray(self.gene_lower, np.float32)
              if self.gene_lower is not None
              else np.full((self.num_genes,), self.lower, np.float32))
        hi = (np.asarray(self.gene_upper, np.float32)
              if self.gene_upper is not None
              else np.full((self.num_genes,), self.upper, np.float32))
        return lo, hi


# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for one LM-family model.

    The fields cover every family of the reference: dense llama-like, MoE,
    Mamba-2 SSD, hybrid (jamba), enc-dec (whisper), and VLM backbones
    (llava). Unused features are disabled by their zero/None defaults.
    """

    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio

    # --- core transformer dims ---
    num_layers: int
    d_model: int
    num_heads: int                  # query heads (0 for attn-free)
    num_kv_heads: int               # GQA kv heads
    d_ff: int                       # dense FFN hidden dim (0 = no dense FFN)
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0            # routed experts (0 = dense)
    experts_per_token: int = 0      # top-k
    moe_d_ff: int = 0               # per-expert hidden dim (0 -> d_ff)
    num_shared_experts: int = 0     # always-on shared experts (qwen2-moe)
    shared_d_ff: int = 0            # shared-expert hidden dim
    moe_every: int = 1              # MoE FFN every Nth layer (jamba: 2)
    router_aux_weight: float = 0.01  # load-balance aux loss weight

    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0              # N: state size per head (0 = no SSM)
    ssm_expand: int = 2             # d_inner = expand * d_model
    ssm_head_dim: int = 64          # P: SSD head dim
    ssm_conv_width: int = 4
    ssm_chunk: int = 256            # SSD chunk length

    # --- hybrid interleave (jamba) ---
    attn_every: int = 0             # 1 attention layer per N layers (0 = per family)

    # --- gemma2-style features ---
    sliding_window: int = 0         # local attention window (alternating archs)
    local_global_alternate: bool = False
    attn_softcap: float = 0.0       # tanh softcap on attention logits
    final_softcap: float = 0.0      # tanh softcap on LM logits
    query_pre_attn_scalar: float = 0.0  # gemma2 uses non-default q scaling

    # --- enc-dec (whisper) ---
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 0            # post-conv frames (whisper: 1500)

    # --- modality frontend stubs ---
    frontend: str = "none"          # none | vision_patches | audio_frames
    frontend_dim: int = 0           # embedding dim delivered by the stub

    # --- positions / misc ---
    pos_embedding: str = "rope"     # rope | learned | none
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    residual_scale: float = 1.0     # minicpm depth scaling: 1.4/sqrt(L)
    embed_scale: float = 1.0        # minicpm scale_emb; gemma sqrt(d)
    act: str = "silu"               # silu | gelu
    post_norm: bool = False         # gemma2: extra post-block norms
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm (whisper)
    param_dtype: str = "float32"    # float32 | bfloat16 (large models)

    # --- periodicity for heterogeneous stacks ---
    # Layers are grouped into `num_layers // scan_period` periods; within a
    # period the (mixer, ffn) kinds are static. The port loops over layers;
    # the period decides each layer's kinds and `is_local_layer`.
    scan_period: int = 1

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_experts and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if self.scan_period <= 0:
            object.__setattr__(self, "scan_period", 1)
        if self.num_layers % self.scan_period:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible "
                f"by scan_period={self.scan_period}")

    # ---- derived helpers ------------------------------------------------
    @property
    def num_periods(self) -> int:
        return self.num_layers // self.scan_period

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 2048, as the reference pads it.
        Labels never index the padding."""
        return (self.vocab_size + 2047) // 2048 * 2048

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def mixer_kind(self, layer_idx: int) -> str:
        """'attn' | 'ssm' for layer `layer_idx` (hybrid interleave)."""
        if self.family in ("ssm",):
            return "ssm"
        if self.attn_every:
            # jamba: one attention layer per `attn_every` layers, placed in
            # the middle of the period (index attn_every//2, as in Jamba).
            return "attn" if (layer_idx % self.attn_every) == self.attn_every // 2 else "ssm"
        return "attn"

    def ffn_kind(self, layer_idx: int) -> str:
        """'moe' | 'dense' | 'none' for layer `layer_idx`."""
        if self.ssm_state and not self.num_experts and self.d_ff == 0:
            return "none"               # pure mamba2: no FFN sublayer
        if self.num_experts and (layer_idx % self.moe_every) == self.moe_every - 1:
            return "moe"
        return "dense" if self.d_ff else "none"

    def is_local_layer(self, layer_idx: int) -> bool:
        """gemma2: even layers sliding-window, odd layers global."""
        return bool(self.local_global_alternate) and (layer_idx % 2 == 0)

    def active_params(self) -> int:
        """Active parameter count per token (MoE counts top-k experts)."""
        return _param_count(self, active_only=True)

    def total_params(self) -> int:
        return _param_count(self)

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing (SSM / hybrid) -> long_500k runs."""
        return self.family in ("ssm", "hybrid")

    def reduced(self) -> "ModelConfig":
        """A tiny config of the same family for CPU smoke tests.

        Keeps every structural feature (GQA ratio, MoE routing, hybrid
        interleave, softcaps, enc-dec, frontends) while shrinking widths,
        depth, vocab and expert counts.
        """
        def shrink(v, lo, hi):
            return 0 if v == 0 else max(lo, min(v, hi))

        n_layers = self.scan_period * max(1, min(2, self.num_periods))
        if self.attn_every:               # keep one full hybrid period
            n_layers = self.scan_period
        heads = shrink(self.num_heads, 1, 4)
        kvh = self.num_kv_heads
        if kvh:
            # preserve MHA vs GQA character
            kvh = heads if kvh == self.num_heads else max(1, heads // 2)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=n_layers,
            d_model=128,
            num_heads=heads,
            num_kv_heads=kvh,
            head_dim=32 if self.num_heads else 0,
            d_ff=0 if self.d_ff == 0 else 256,
            vocab_size=512,
            num_experts=shrink(self.num_experts, 4, 8),
            experts_per_token=shrink(self.experts_per_token, 1, 2),
            moe_d_ff=0 if self.num_experts == 0 else 64,
            num_shared_experts=shrink(self.num_shared_experts, 1, 1),
            shared_d_ff=0 if self.num_shared_experts == 0 else 128,
            ssm_state=shrink(self.ssm_state, 16, 16),
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=32,
            sliding_window=shrink(self.sliding_window, 16, 16),
            encoder_layers=shrink(self.encoder_layers, 2, 2),
            encoder_seq=shrink(self.encoder_seq, 16, 16),
            frontend_dim=128 if self.frontend != "none" else 0,
            embed_scale=self.embed_scale if self.embed_scale == 1.0 else 8.0,
            param_dtype="float32",
        )


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Analytic parameter count (with ``active_only``, a token's: top-k
    experts of each MoE layer)."""
    n = 0
    n += cfg.vocab_size * cfg.d_model                    # embed
    if not cfg.tie_embeddings:
        n += cfg.vocab_size * cfg.d_model                # unembed
    for i in range(cfg.num_layers):
        kind = cfg.mixer_kind(i)
        if kind == "attn":
            q = cfg.d_model * cfg.num_heads * cfg.head_dim
            kv = 2 * cfg.d_model * cfg.num_kv_heads * cfg.head_dim
            o = cfg.num_heads * cfg.head_dim * cfg.d_model
            n += q + kv + o
        else:                                            # ssm
            d_in = cfg.d_inner
            nh = cfg.ssm_heads
            # in_proj -> [z, x, B, C, dt]; B/C use n_groups=1
            n += cfg.d_model * (2 * d_in + 2 * cfg.ssm_state + nh)
            n += d_in * cfg.ssm_conv_width               # depthwise conv
            n += d_in * cfg.d_model                      # out_proj
            n += 2 * nh                                  # A_log, D
        f = cfg.ffn_kind(i)
        if f == "dense":
            n += 3 * cfg.d_model * cfg.d_ff
        elif f == "moe":
            e = cfg.experts_per_token if active_only else cfg.num_experts
            n += 3 * cfg.d_model * cfg.moe_d_ff * e
            n += cfg.d_model * cfg.num_experts           # router
            if cfg.num_shared_experts:
                n += 3 * cfg.d_model * (cfg.shared_d_ff or cfg.moe_d_ff * cfg.num_shared_experts)
        n += 2 * cfg.d_model                             # norms
    if cfg.is_encoder_decoder:
        # encoder self-attn + ffn + decoder cross-attn
        enc = cfg.encoder_layers * (
            4 * cfg.d_model * cfg.num_heads * cfg.head_dim
            + 2 * cfg.d_model * cfg.d_ff + 2 * cfg.d_model)
        cross = cfg.num_layers * (4 * cfg.d_model * cfg.num_heads * cfg.head_dim)
        n += enc + cross
    return n


# ---------------------------------------------------------------------------
# Input-shape cells (the reference's dry-run shape contract)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped) for one (arch x shape) cell."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("full-attention arch: 500k decode KV cache is "
                       "quadratic-history / O(100s GiB) per replica; "
                       "skipped per shape contract (DESIGN.md §3)")
    return True, ""
