"""Configuration schema of the PyTorch port: its own copy of the JAX
package's ``MoEConfig``, ``SSMConfig``, ``ModelConfig``, ``ShapeConfig``
(and ``INPUT_SHAPES``), ``MeshConfig``, ``TrainConfig`` and
``HardwareConfig``, field for field, so that one configuration describes
the same model and the same training run in both packages.  The port's
hardware model is the card it runs on (``H100``), not the JAX package's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple, Union


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts sub-config (paper's target substrate)."""

    num_experts: int = 0
    experts_per_token: int = 0          # top-k
    d_ff: int = 0                       # per-expert hidden dim
    # Which layers carry an MoE FFN: every `period` layers, offset `offset`.
    period: int = 1
    offset: int = 0
    capacity_factor: float = 2.0        # GShard-style dispatch capacity
    aux_loss_weight: float = 1e-2       # load-balance loss (GShard)
    router_z_loss_weight: float = 1e-3
    # FSSDP knobs ------------------------------------------------------
    # m: extra materialization slots per device (Alg. 1's memory capacity).
    slots_per_device: int = 2
    # q: static all_to_all rounds == max experts per (owner, dest) pair.
    a2a_rounds: int = 1
    # strategy: "fssdp" (paper), "ep" (baseline), "fsdp" (dense all-gather).
    strategy: str = "fssdp"
    # Re-materialization mode — what the backward does about the per-layer
    # (K, chunk_len) materialized expert chunks (paper §4.3):
    #   "save"   keep each layer's chunks as an AD residual (no backward
    #            materialization collectives; highest chunk memory),
    #   "gather" TRUE re-materialization: store NO chunk residuals — the
    #            backward replays the SparseAllGather from the sharded
    #            buffer and re-runs the MoE layer under the VJP (the
    #            SparseReduceScatter transpose lands the buffer grads),
    #   "block"  recompute the whole superblock under nothing_saveable
    #            (least memory, most recompute; disables the cross-layer
    #            materialization pipeline — see `pipeline`).
    # Booleans are accepted for backward compatibility:
    #   False -> "save", True -> "block".
    rematerialize: Union[str, bool] = "save"
    # One-layer-ahead materialization pipeline (§4.2): the superblock scan
    # carries the NEXT MoE layer's prefetched chunks so SparseAllGather
    # (ring/a2a + FSDP all-gather) overlaps the previous layer's
    # attention/FFN compute instead of only its own gate.  Costs holding
    # two layers' chunks at peak.  Ignored without a mesh, forced off
    # under rematerialize="block" (the carried chunks would defeat the
    # nothing-saveable memory goal), and REQUIRED by
    # rematerialize="gather" (the backward re-gather consumes the
    # prefetched slots — validated in __post_init__).
    pipeline: bool = True
    # Explicit backward re-gather pipeline (rematerialize="gather" only):
    # layer l's backward consumes compute slots re-gathered one backward
    # step earlier and issues layer l-1's re-gather BEFORE its own
    # dgrad/wgrad kernels (the backward mirror of `pipeline`, transported
    # through a chunk-shaped pipe channel — see
    # repro.core.moe.moe_layer_regather_pipelined).  Off = the legacy
    # regather VJP, which gathers its own chunks at the head of its
    # backward and relies on the async collective scheduler to hoist them.
    bwd_prefetch: bool = True

    def __post_init__(self):
        remat = self.rematerialize
        if isinstance(remat, bool):
            remat = "block" if remat else "save"
        if remat not in ("save", "gather", "block"):
            raise ValueError(
                f"moe.rematerialize must be 'save' | 'gather' | 'block' "
                f"(or a legacy bool), got {self.rematerialize!r}")
        if remat == "gather" and not self.pipeline:
            # the regather VJP only engages on the prefetched (premat)
            # path; without the pipeline the serial path would silently
            # store every layer's chunks — save-mode memory under a
            # config that asked for the opposite.  Fail fast instead.
            raise ValueError(
                "moe.rematerialize='gather' requires moe.pipeline=True "
                "(the backward re-gather consumes the pipelined prefetch; "
                "use 'save' or 'block' with pipeline=False)")
        object.__setattr__(self, "rematerialize", remat)

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) sub-config."""

    state_dim: int = 128                # N
    head_dim: int = 64                  # P
    expand: int = 2                     # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 64                     # SSD chunk length

    def num_heads(self, d_model: int) -> int:
        return self.expand * d_model // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 -> d_model // num_heads
    # --- attention options -------------------------------------------
    qkv_bias: bool = False              # qwen1.5
    rope_theta: float = 10_000.0
    attn_logit_softcap: float = 0.0     # gemma2 (50.0)
    final_logit_softcap: float = 0.0    # gemma2 (30.0)
    sliding_window: int = 0             # gemma2 local layers (4096)
    mrope: bool = False                 # qwen2-vl multimodal RoPE
    # Block-paged decode attention via the Pallas kernel
    # (repro.kernels.paged_attention) — reads the page table directly from
    # the flat KV pool, native GQA, online softmax in f32.  False forces
    # the pure-XLA gather path (k[row_idx] per step), which stays
    # BIT-exact with the dense cache; the kernel is reduction-order-exact
    # to ≤1e-6 in f32 (tests/test_serve_batching.py asserts both).
    paged_attn_kernel: bool = True
    # Repeating unit of layer kinds, tiled to num_layers.  Kinds:
    #   "attn"    causal global attention + FFN
    #   "local"   sliding-window attention + FFN
    #   "mamba"   Mamba-2 SSD block
    # The FFN of a layer is MoE iff moe.enabled and layer_idx % period == offset.
    layer_pattern: Tuple[str, ...] = ("attn",)
    # --- submodule configs -------------------------------------------
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    # --- encoder-decoder (whisper) ------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq_len: int = 0            # whisper: 1500 frames
    max_decoder_len: int = 0            # architecture cap (whisper: 448)
    # --- modality frontend stub ---------------------------------------
    # None | "audio" | "vision": input_specs() yields embeddings directly.
    frontend: Optional[str] = None
    # --- misc ----------------------------------------------------------
    norm: str = "rms"                   # rms | ln
    act: str = "silu_glu"               # silu_glu | gelu
    tie_embeddings: bool = True
    dtype: str = "bfloat16"             # compute dtype
    param_dtype: str = "float32"        # master params
    remat: bool = True                  # activation checkpointing per block
    source: str = ""                    # citation

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if len(self.layer_pattern) == 0:
            raise ValueError("layer_pattern must be non-empty")
        if self.num_layers % len(self.layer_pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"layer_pattern of length {len(self.layer_pattern)}")

    # ---- derived ------------------------------------------------------
    @property
    def num_superblocks(self) -> int:
        return self.num_layers // len(self.layer_pattern)

    def layer_kinds(self) -> Tuple[str, ...]:
        return tuple(self.layer_pattern) * self.num_superblocks

    def is_moe_layer(self, layer_idx: int) -> bool:
        if not self.moe.enabled:
            return False
        if self.layer_kinds()[layer_idx] == "mamba" and self.arch_type != "hybrid":
            return False
        return layer_idx % self.moe.period == self.moe.offset

    def supports_long_context(self) -> bool:
        """True if decode over very long KV is sub-quadratic / bounded."""
        kinds = set(self.layer_pattern)
        if kinds <= {"mamba"}:
            return True
        if "mamba" in kinds:            # hybrid: state O(1), attn layers stream cache
            return True
        if self.sliding_window > 0:     # local/global alternating (gemma2)
            return True
        return False

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks)."""
        d, hd = self.d_model, self.head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads
        total = self.vocab_size * d
        if not self.tie_embeddings:
            total += self.vocab_size * d
        kinds = self.layer_kinds()
        for i, kind in enumerate(kinds):
            if kind in ("attn", "local"):
                total += d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
                if self.qkv_bias:
                    total += (n_q + 2 * n_kv) * hd
            elif kind == "mamba":
                s = self.ssm
                d_in = s.expand * d
                nh = s.num_heads(d)
                total += d * (2 * d_in + 2 * s.state_dim + nh)   # in_proj
                total += s.conv_width * (d_in + 2 * s.state_dim)  # conv
                total += 2 * nh                                    # A_log, D
                total += d_in * d                                  # out_proj
            # FFN
            n_mats = 3 if self.act.endswith("_glu") else 2
            if self.is_moe_layer(i):
                total += d * self.moe.num_experts                   # router
                total += self.moe.num_experts * n_mats * d * self.moe.d_ff
            elif kind != "mamba":
                total += n_mats * d * self.d_ff
            total += 2 * d                                         # norms
        if self.is_encoder_decoder:
            # encoder blocks (attn + ffn) + decoder cross-attention
            n_mats = 3 if self.act.endswith("_glu") else 2
            enc = self.encoder_layers * (
                d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
                + n_mats * d * self.d_ff + 2 * d)
            xattn = self.num_layers * (
                d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d + d)
            total += enc + xattn
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k of experts)."""
        if not self.moe.enabled:
            return self.param_count()
        total = self.param_count()
        moe_layers = sum(self.is_moe_layer(i) for i in range(self.num_layers))
        n_mats = 3 if self.act.endswith("_glu") else 2
        expert_p = n_mats * self.d_model * self.moe.d_ff
        inactive = moe_layers * (self.moe.num_experts - self.moe.experts_per_token) * expert_p
        return total - inactive

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                           # "train" | "prefill" | "decode"


# The dry run's input shapes (``launch.dryrun``), the JAX package's.
INPUT_SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,   32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",  524_288,    1, "decode"),
}


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axes if a != "model")

    @property
    def model_size(self) -> int:
        return self.shape[self.axes.index("model")]

    @property
    def batch_size(self) -> int:
        return self.num_devices // self.model_size


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    seed: int = 0
    microbatch: int = 0                 # 0 = no gradient accumulation
    # --- fault tolerance (train.trainer.train_loop) ------------------
    # Step-health guard: skip the optimizer update when the loss or the
    # gradient global norm is non-finite (the check rides the clipping
    # gnorm and the existing metrics readback — no extra device sync).
    # The skipped step's params/moments are bit-identical to the step
    # before it; state.step still advances (one batch was consumed).
    step_guard: bool = True
    # Consecutive skipped steps tolerated before train_loop aborts with
    # rollback to the last intact checkpoint (TrainAbortError).
    max_bad_steps: int = 3
    # Crash-safe training: "" disables periodic checkpointing.
    checkpoint_dir: str = ""
    checkpoint_every: int = 0           # steps between saves (0 = off)
    keep_checkpoints: int = 3           # keep-last retention
    # Auto-resume from the newest INTACT checkpoint when train_loop is
    # started without an explicit state.
    auto_resume: bool = True


# Roofline constants of one accelerator, the fields of the JAX package's
# ``HardwareConfig``.  ``ici_bw`` is the rate of one device's link to its
# peers in one direction (NVLink on the H100).
@dataclass(frozen=True)
class HardwareConfig:
    name: str
    peak_flops_bf16: float              # dense, per device
    hbm_bw: float                       # bytes/s per device
    ici_bw: float                       # bytes/s per link direction
    hbm_bytes: float                    # device memory


# NVIDIA H100 SXM, from NVIDIA's data sheet: 989 TFLOP/s dense bf16,
# 3.35 TB/s HBM3, 900 GB/s NVLink (450 GB/s per direction), 80 GB.
H100 = HardwareConfig(name="h100_sxm", peak_flops_bf16=989e12,
                      hbm_bw=3.35e12, ici_bw=450e9, hbm_bytes=80e9)
