"""Unified architecture config covering all six assigned families.

A copy of `repro/models/lm/config.py` (pure Python, no JAX), so that the
port needs nothing of the reference.  One frozen dataclass describes dense
/ MoE / SSM / hybrid / VLM / audio backbones; family-specific fields are
zero/empty when unused.  Configs for the ten assigned architectures live
in `repro_torch.configs.<id>` and cite their source papers.  The
`scan_layers` field is kept so configs compare equal field by field with
the reference's; the port's model does not read it (`remat` and
`attn_remat` it does, in training).  The mesh fields are armed by
`launch.sharding.launch_cfg` as the reference's are; the model takes its
layout from the ambient mesh and checks it against them
(`models/lm/tp.py::constrain`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                # query heads (0 for attention-free SSM)
    n_kv_heads: int
    d_ff: int                   # dense FFN width (per-expert width for MoE)
    vocab: int
    head_dim: int = 0           # 0 => d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 1         # dispatch groups; launcher sets == data shards

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0          # N
    ssm_head_dim: int = 64      # P
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4

    # --- attention details ---
    rope_theta: float = 1e4
    rope_frac: float = 1.0      # chatglm "RoPE 2d": rotary on half the head dim
    window: int = 0             # sliding-window size (0 = full attention)
    ffn_kind: str = "swiglu"    # swiglu | gelu
    norm_kind: str = "rms"      # rms | layer

    # --- modality frontends (STUB: precomputed embeddings, see DESIGN.md) ---
    frontend: str = "none"      # none | vision | audio
    n_frontend_tokens: int = 0  # vision patches / audio frames

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0     # 0 => decoder-only

    # --- numerics / distribution ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"   # "bfloat16" halves FSDP gathers + grad ARs
    parallelism: str = "tp"        # "tp": model axis shards weights;
                                   # "dp": model axis joins the batch axes
                                   # (right for small / non-divisible-head archs)
    attn_remat: bool = False       # checkpoint each flash KV block (backward
                                   # recomputes per block: peak mem / n_blocks)
    # sharding-constraint hooks: set by the launcher (empty => no-op, so
    # CPU smoke tests never touch mesh state)
    mesh_batch_axes: tuple = ()   # e.g. ("data",) or ("pod", "data")
    mesh_batch_sizes: tuple = ()  # matching axis sizes, for divisibility checks
    mesh_model_axis: str = ""     # e.g. "model"
    mesh_model_size: int = 0
    fsdp: bool = False          # shard params over the data axis too (>=10B)
    remat: bool = True          # activation checkpointing per layer
    scan_layers: bool = True    # False => python-unrolled layers (used by the
                                # roofline assembler: XLA HloCostAnalysis
                                # counts a while body once, not L times)
    optimizer: str = "adamw"    # adamw | sgd (paper's client optimizer)
    attn_chunk: int = 512       # flash kv-block size
    attn_impl: str = "auto"     # auto | dense | flash

    # source citation (paper table / model card)
    source: str = ""

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def has_attn(self) -> bool:
        return self.n_heads > 0

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def subquadratic(self) -> bool:
        """Can this arch run long_500k decode? (SSM state or bounded window.)"""
        if self.has_attn:
            return self.window > 0   # sliding-window: O(W) cache
        return self.has_ssm          # attention-free SSM: O(1) state

    def reduced(self, *, n_layers: int = 2, d_model: int | None = None,
                max_experts: int = 4) -> "ArchConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
        d = min(self.d_model, d_model or 256)
        # keep head structure but shrink
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = min(self.n_kv_heads, max(n_heads // 2, 1)) if n_heads else 0
        upd = dict(
            name=self.name + "-reduced",
            n_layers=n_layers,
            encoder_layers=min(self.encoder_layers, n_layers) if self.encoder_layers else 0,
            d_model=d,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=d // max(n_heads, 1) if n_heads else 0,
            d_ff=min(self.d_ff, 2 * d) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, max_experts),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.has_ssm else self.ssm_head_dim,
            ssm_chunk=64,
            window=min(self.window, 64) if self.window else 0,
            n_frontend_tokens=min(self.n_frontend_tokens, 8) if self.n_frontend_tokens else 0,
            dtype="float32",
            fsdp=False,
            remat=False,
            attn_impl="auto",
        )
        return dataclasses.replace(self, **upd)


def _attn_params(cfg: ArchConfig) -> int:
    if not cfg.has_attn:
        return 0
    d, hd = cfg.d_model, cfg.hd
    return d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d


def _ffn_params(cfg: ArchConfig) -> int:
    if cfg.is_moe:
        per = (3 if cfg.ffn_kind == "swiglu" else 2) * cfg.d_model * cfg.d_ff
        return cfg.n_experts * per + cfg.d_model * cfg.n_experts  # + router
    if cfg.d_ff == 0:
        return 0
    return (3 if cfg.ffn_kind == "swiglu" else 2) * cfg.d_model * cfg.d_ff


def _ssm_params(cfg: ArchConfig) -> int:
    if not cfg.has_ssm:
        return 0
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    d_in_proj = 2 * di + 2 * n + h       # z, x, B, C, dt (G=1 group)
    conv_dim = di + 2 * n
    return d * d_in_proj + cfg.ssm_conv * conv_dim + 3 * h + di + di * d


def _layer_params(cfg: ArchConfig) -> int:
    p = cfg.d_model  # norm1
    if cfg.d_ff > 0 or cfg.is_moe:
        p += cfg.d_model  # norm2 (pre-FFN)
    p += _attn_params(cfg) + _ffn_params(cfg) + _ssm_params(cfg)
    if cfg.family == "hybrid":
        p += 2 * cfg.d_model  # per-branch output norms (attn + ssm)
    return p


def param_count(cfg: ArchConfig) -> int:
    """Analytic total parameter count (matches init_params within ties)."""
    total = cfg.vocab * cfg.d_model            # embed
    total += cfg.d_model * cfg.vocab           # untied lm head
    total += cfg.d_model                       # final norm
    total += cfg.n_layers * _layer_params(cfg)
    if cfg.encoder_layers:                     # whisper encoder + cross-attn
        enc_layer = 2 * cfg.d_model + _attn_params(cfg) + _ffn_params(cfg)
        total += cfg.encoder_layers * enc_layer
        total += cfg.d_model                                        # enc final norm
        total += cfg.n_layers * (_attn_params(cfg) + cfg.d_model)  # cross-attn
    return total


def active_param_count(cfg: ArchConfig) -> int:
    """Params touched per token (MoE: top_k of n_experts)."""
    if not cfg.is_moe:
        return param_count(cfg)
    per_expert = (3 if cfg.ffn_kind == "swiglu" else 2) * cfg.d_model * cfg.d_ff
    inactive = cfg.n_layers * (cfg.n_experts - cfg.top_k) * per_expert
    return param_count(cfg) - inactive
