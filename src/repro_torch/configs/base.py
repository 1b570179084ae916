"""Configuration dataclasses for the SWAP framework (PyTorch port).

A field-for-field copy of the JAX package's ``repro/configs/base.py``, so
``dataclasses.asdict`` of a port config equals that of the reference. The
only change is where ``attention_impl``/``ssd_impl`` are validated: against
the port's own ``repro_torch.kernels.dispatch.KERNEL_IMPLS``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

ARCH_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio", "cnn")


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration (GShard-style capacity dispatch)."""

    n_experts: int = 0
    top_k: int = 0
    d_ff: int = 0                  # per-expert hidden width
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    n_shared_experts: int = 0      # always-on experts (deepseek-style); 0 = none
    shared_d_ff: int = 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block configuration."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64             # SSD head dim (P)
    n_groups: int = 1              # B/C groups (GVA-style)
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1
    a_init_range: Tuple[float, float] = (1.0, 16.0)


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek/MiniCPM3-style)."""

    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class ModelConfig:
    """A single architecture. One instance per assigned arch (full + smoke)."""

    name: str
    family: str                    # one of ARCH_FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # attention flavour
    attention: str = "gqa"         # "gqa" | "mla" | "none"
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0        # 0 -> full attention
    # local:global layer pattern, e.g. (5, 1) = 5 sliding-window layers then 1 global.
    # (0, 0) -> uniform layers.
    local_global_pattern: Tuple[int, int] = (0, 0)
    # M-RoPE (qwen2-vl): rope split into (temporal, height, width) sections.
    mrope_sections: Tuple[int, ...] = ()

    # family-specific blocks
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    # hybrid (zamba2): one SHARED attention block applied every k mamba layers
    shared_attn_every: int = 0

    # enc-dec (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500        # stub frame-embedding count

    # vlm stub
    n_vision_tokens: int = 0       # patch embeds prepended to the sequence

    # norms / misc
    norm: str = "rmsnorm"          # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"              # "silu" | "gelu"
    dtype: str = "bfloat16"        # activation/compute dtype for lowering
    param_dtype: str = "float32"

    # implementation switches, resolved per tensor device by
    # repro_torch.kernels.dispatch: "auto" is the hand-written kernel on
    # CUDA and the plain PyTorch version on the CPU; "kernel" /
    # "reference" / "naive" force a path ("kernel" raises on the CPU).
    attention_impl: str = "auto"   # one of dispatch.KERNEL_IMPLS
    ssd_impl: str = "auto"         # one of dispatch.KERNEL_IMPLS
    # optional pinned tuning design points, (block_q, block_k, num_warps,
    # num_stages); kept for config parity, the port has no tuning cache yet.
    attention_design: Tuple[int, ...] = ()
    ssd_design: Tuple[int, ...] = ()
    attention_chunk: int = 512          # kv block for blockwise reference attn
    remat: bool = True                  # checkpoint each layer in train_step
    # remat policy: "full" recomputes everything; "dots" saves matmul
    # outputs (jax dots_with_no_batch_dims_saveable) — trades HBM capacity
    # for a large cut in recompute bytes/flops (§Perf iter 5).
    remat_policy: str = "dots"
    scan_layers: bool = True            # lax.scan over stacked layer params
    # pin the residual stream to batch-sharded at block boundaries; helped
    # nothing once the MoE-internal constraints existed and hurts some
    # dense-attention partitions — off by default (§Perf iter 3b).
    constrain_residual: bool = False
    # KV-cache storage: "" = activation dtype; "int8" = symmetric per
    # (token, head) quantization — halves the decode memory-roofline term
    # for attention archs (beyond-paper; GQA caches only).
    kv_cache_dtype: str = ""

    # CNN (paper-faithful CIFAR-analog model)
    cnn_channels: Tuple[int, ...] = ()
    n_classes: int = 0
    image_size: int = 32

    def __post_init__(self):
        if self.family not in ARCH_FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        # validate impl strings at construction, not deep inside a forward
        # (function-local import: dispatch imports torch, configs need not)
        from repro_torch.kernels.dispatch import validate_impl
        validate_impl(self.attention_impl, "ModelConfig.attention_impl")
        validate_impl(self.ssd_impl, "ModelConfig.ssd_impl")
        for fld in ("attention_design", "ssd_design"):
            pin = getattr(self, fld)
            if pin and len(pin) != 4:
                raise ValueError(
                    f"ModelConfig.{fld} must be () or a 4-tuple (block_q, "
                    f"block_k, num_warps, num_stages); got {pin!r}")

    @property
    def d_head_q(self) -> int:
        if self.attention == "mla":
            return self.mla.qk_nope_head_dim + self.mla.qk_rope_head_dim
        return self.head_dim

    # ---------------- parameter counting (for roofline MODEL_FLOPS) --------
    def param_count(self) -> int:
        """Total parameters (analytic, matches init to within ties/norms)."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """Parameters active per token (MoE: only top_k experts count)."""
        return _param_count(self, active_only=True)


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    if cfg.family == "cnn":
        # rough CNN count: conv 3x3 chains
        total, prev = 0, 3
        for c in cfg.cnn_channels:
            total += 3 * 3 * prev * c + 2 * c
            prev = c
        total += prev * cfg.n_classes
        return total

    d, v = cfg.d_model, cfg.vocab_size
    total = v * d                       # embed
    if not cfg.tie_embeddings:
        total += v * d                  # lm head

    def attn_params() -> int:
        if cfg.attention == "mla":
            m = cfg.mla
            qh = m.qk_nope_head_dim + m.qk_rope_head_dim
            p = d * m.q_lora_rank + m.q_lora_rank * cfg.n_heads * qh
            p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            p += m.kv_lora_rank * cfg.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            p += cfg.n_heads * m.v_head_dim * d
            return p
        hd = cfg.head_dim
        p = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
        p += cfg.n_heads * hd * d
        if cfg.qkv_bias:
            p += (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
        return p

    def mlp_params() -> int:
        return 3 * d * cfg.d_ff  # swiglu: wi, wg, wo

    def moe_params() -> int:
        m = cfg.moe
        n_e = m.top_k if active_only else m.n_experts
        p = d * m.n_experts                        # router (always)
        p += n_e * 3 * d * m.d_ff
        if m.n_shared_experts:
            p += m.n_shared_experts * 3 * d * m.shared_d_ff
        return p

    def ssm_params() -> int:
        s = cfg.ssm
        d_in = s.expand * d
        nh = d_in // s.head_dim
        p = d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)   # in_proj
        p += s.d_conv * (d_in + 2 * s.n_groups * s.d_state)    # conv
        p += nh * 2                                            # A_log, D
        p += d_in * d                                          # out_proj
        return p

    if cfg.family in ("dense", "vlm"):
        total += cfg.n_layers * (attn_params() + mlp_params())
    elif cfg.family == "moe":
        total += cfg.n_layers * (attn_params() + moe_params())
    elif cfg.family == "ssm":
        total += cfg.n_layers * ssm_params()
    elif cfg.family == "hybrid":
        total += cfg.n_layers * ssm_params()
        total += attn_params() + mlp_params()      # ONE shared attention block
    elif cfg.family == "audio":
        total += cfg.n_layers * (2 * attn_params() + mlp_params())  # self+cross
        total += cfg.n_encoder_layers * (attn_params() + mlp_params())
    return total


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# archs allowed to run long_500k (sub-quadratic decode); see DESIGN.md §4
LONG_CONTEXT_ARCHS = ("mamba2-2.7b", "zamba2-7b", "gemma3-1b")


def shape_applicable(arch_name: str, family: str, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return arch_name in LONG_CONTEXT_ARCHS or family in ("ssm", "hybrid")
    return True


# ---------------------------------------------------------------------------
# Mesh / distribution
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))


# ---------------------------------------------------------------------------
# Optimization / schedules / SWAP
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ScheduleConfig:
    """Piecewise-linear warmup + decay, or cyclic (for SWA sampling)."""

    kind: str = "warmup_linear"    # "warmup_linear" | "warmup_cosine" | "cyclic" | "const"
    peak_lr: float = 0.1
    warmup_steps: int = 0
    total_steps: int = 1000
    end_lr: float = 0.0
    cycle_steps: int = 0           # for "cyclic"
    min_lr: float = 0.0


@dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "sgd"              # "sgd" | "lars" | "adamw"
    momentum: float = 0.9
    nesterov: bool = True
    weight_decay: float = 5e-4
    # adamw
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    # lars
    trust_coefficient: float = 0.001
    # DEPRECATED: set PhaseConfig.precision / PrecisionPolicy.grad_dtype
    # instead. Still parsed (resolve_policy folds it into the policy, and
    # the cast now happens inside the precision step — after unscaling,
    # before the data-axis psum — rather than as a loose post-grad cast).
    grad_dtype: str = "float32"


@dataclass(frozen=True)
class PhaseConfig:
    """One SWAP phase (1 = large-batch sync, 2 = small-batch independent)."""

    batch_size: int = 512          # GLOBAL batch (phase 2: per worker)
    schedule: ScheduleConfig = field(default_factory=ScheduleConfig)
    max_steps: int = 1000
    stop_accuracy: float = 1.01    # phase-1 early exit threshold τ (>1 = never)
    accuracy_ema: float = 0.9      # smoothing for the stopping criterion
    # numerics (repro.train.precision): PrecisionPolicy preset name —
    # "float32" | "bfloat16" | "float16" (f16 adds dynamic loss scaling
    # with inf/nan step skipping). Phase 2 should stay "float32" so the
    # averaging/generalization claims are untouched; phase 1 is where the
    # large-batch compute lives.
    precision: str = "float32"
    # microbatch accumulation: split each global batch into this many
    # sequential microbatches inside the step (inner lax.scan) — identical
    # effective batch size for the gradient, ~grad_accum_steps× smaller
    # activation memory, so phase-1 batches larger than device memory
    # still run. Caveat: BatchNorm statistics become per-microbatch (see
    # docs/training.md §Precision & accumulation); fused-step equivalence
    # holds exactly only for stateless models.
    grad_accum_steps: int = 1


@dataclass(frozen=True)
class SWAPConfig:
    """The paper's algorithm (Algorithm 1)."""

    n_workers: int = 8
    phase1: PhaseConfig = field(default_factory=PhaseConfig)
    phase2: PhaseConfig = field(default_factory=PhaseConfig)
    # phase-3 batch-norm statistic recompute passes (no-op for norm-stat-free models)
    bn_recompute_batches: int = 8
    bn_recompute_batch_size: int = 256
    seed: int = 0
    # periodic TrainState snapshots (repro.checkpoint.state): every N steps,
    # landing on epoch-aligned chunk boundaries; 0 / "" disables. Resume via
    # SWAP.run(resume=True) restarts bit-exactly mid-phase-1 or mid-phase-2.
    checkpoint_dir: str = ""
    checkpoint_every: int = 0


@dataclass(frozen=True)
class SWAConfig:
    """Sequential SWA baseline (Izmailov et al. 2018) for Table-4 comparisons."""

    n_samples: int = 8             # models averaged
    cycle_steps: int = 100         # steps between samples (cyclic LR period)
    schedule: ScheduleConfig = field(default_factory=lambda: ScheduleConfig(kind="cyclic"))
    batch_size: int = 512
    seed: int = 0


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = None
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    swap: SWAPConfig = field(default_factory=SWAPConfig)
    mesh: MeshConfig = field(default_factory=lambda: SINGLE_POD)
    seq_len: int = 4096
    eval_batches: int = 4
    eval_batch_size: int = 256
    log_every: int = 10
    checkpoint_dir: str = ""
    data_seed: int = 1234


def replace(cfg, **kw):
    """dataclasses.replace that tolerates nested dotted keys ('moe.top_k')."""
    direct = {k: v for k, v in kw.items() if "." not in k}
    nested = {k: v for k, v in kw.items() if "." in k}
    out = dataclasses.replace(cfg, **direct) if direct else cfg
    for key, val in nested.items():
        head, rest = key.split(".", 1)
        out = dataclasses.replace(out, **{head: replace(getattr(out, head), **{rest: val})})
    return out
