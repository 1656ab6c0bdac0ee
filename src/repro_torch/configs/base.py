"""Configuration dataclasses: the decoder's ``ModelConfig``, the
``ImplContext`` that folds the CLI's kernel choices into it, and the IMPALA
learner's ``TrainConfig`` (each field for field as in ``repro``).

A ``ModelConfig`` fully describes a decoder. It is ``num_groups``
repetitions of a *super-block*: a tuple of ``(mixer, ffn)`` layer specs.
The port keeps one parameter set per group (``models/model.py``).

Mixer kinds:   attn | local_attn | swa_attn | xattn | mamba | mlstm | slstm
FFN kinds:     swiglu | geglu | gelu | moe | none
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

LayerSpec = Tuple[str, str]  # (mixer, ffn)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense | ssm | moe | hybrid | vlm | audio
    source: str                         # citation for the architecture numbers

    d_model: int
    num_heads: int
    num_kv_heads: int
    vocab_size: int
    d_ff: int

    block_pattern: Tuple[LayerSpec, ...]
    num_groups: int                     # layers = num_groups * len(block_pattern)

    head_dim: int = 0                   # 0 -> d_model // num_heads

    # --- attention options -------------------------------------------------
    use_qk_norm: bool = False
    pos_emb: str = "rope"               # rope | sinusoidal | none
    rope_theta: float = 1e4
    sliding_window: int = 4096          # for local_attn / swa_attn mixers
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    attn_scale: Optional[float] = None  # None -> 1/sqrt(head_dim)

    # --- norms / residual ---------------------------------------------------
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    norm_eps: float = 1e-6
    sandwich_norm: bool = False         # gemma2 pre+post sublayer norms
    embed_scale: bool = False           # gemma: scale embeddings by sqrt(d)
    tie_embeddings: bool = False

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3

    # --- SSM (Mamba2) ---------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # --- xLSTM ----------------------------------------------------------------
    xlstm_chunk: int = 64

    # --- zamba-style shared global block --------------------------------------
    shared_attn_every: int = 0          # >0: shared attn+mlp block after each group

    # --- VLM ------------------------------------------------------------------
    vision_seq: int = 0                 # stub patch-embedding sequence length

    # --- RL heads ---------------------------------------------------------------
    baseline_head: bool = True          # value head for IMPALA

    # --- numerics / impl ---------------------------------------------------------
    dtype: str = "bfloat16"
    # auto | xla | xla_chunked | xla_chunked_skip | kernel (the names
    # "xla*" are kept so that configs and flags read as in the reference:
    # here they name the port's plain PyTorch paths)
    attn_impl: str = "auto"
    attn_chunk: int = 1024
    ssd_impl: str = "xla"               # xla | kernel (mamba chunk scan)
    remat: bool = True
    # serving adaptation for long contexts on pure full-attention archs
    long_context_window: int = 8192

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def num_layers(self) -> int:
        return self.num_groups * len(self.block_pattern)

    @property
    def is_recurrent(self) -> bool:
        return any(m in ("mamba", "mlstm", "slstm") for m, _ in self.block_pattern)

    @property
    def is_subquadratic(self) -> bool:
        """True if no mixer needs an unbounded KV cache."""
        for mixer, _ in self.block_pattern:
            if mixer in ("attn", "xattn"):
                return False
        if self.shared_attn_every:
            return False  # shared attn is full unless long-context windowed
        return True

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + heads)."""
        d, hd = self.d_model, self.resolved_head_dim
        n = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d
        for mixer, ffn in self.block_pattern * self.num_groups:
            if mixer in ("attn", "local_attn", "swa_attn", "xattn"):
                n += d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                n += self.num_heads * hd * d
                n += d  # norm
                if self.use_qk_norm:
                    n += 2 * hd
            elif mixer == "mamba":
                d_in = self.ssm_expand * d
                nheads = d_in // self.ssm_head_dim
                n += d * (2 * d_in + 2 * self.ssm_state + nheads)  # in_proj(zx) + B,C, dt
                n += d_in * d + d + 2 * nheads + d_in * self.ssm_conv_width
            elif mixer in ("mlstm", "slstm"):
                d_in = 2 * d
                n += d * d_in * 2 + d_in * d + 3 * d * self.num_heads + d
            if ffn == "moe":
                n += self.num_experts * 3 * d * self.moe_d_ff + d * self.num_experts + d
            elif ffn in ("swiglu", "geglu"):
                n += 3 * d * self.d_ff + d
            elif ffn == "gelu":
                n += 2 * d * self.d_ff + d
        if self.shared_attn_every:
            n += d * self.num_heads * hd * 2 + 2 * d * self.num_kv_heads * hd
            n += 3 * d * self.d_ff
        if self.baseline_head:
            n += d
        n += d  # final norm
        return n


@dataclasses.dataclass(frozen=True)
class ImplContext:
    """Kernel-implementation choices, resolved once at the CLI boundary:
    ``apply`` folds ``--attn-impl`` / ``--ssd-impl`` into the config, and
    every path below reads ``cfg.attn_impl`` / ``cfg.ssd_impl``. ``None``
    fields keep the config's existing choice."""
    attn: Optional[str] = None   # auto | xla | xla_chunked | xla_chunked_skip | kernel
    ssd: Optional[str] = None    # xla | kernel

    @classmethod
    def from_args(cls, args) -> "ImplContext":
        """Build from an argparse namespace carrying --attn-impl/--ssd-impl."""
        return cls(attn=getattr(args, "attn_impl", None),
                   ssd=getattr(args, "ssd_impl", None))

    def apply(self, cfg: "ModelConfig") -> "ModelConfig":
        over = {}
        if self.attn:
            over["attn_impl"] = self.attn
        if self.ssd:
            over["ssd_impl"] = self.ssd
        return dataclasses.replace(cfg, **over) if over else cfg


@dataclasses.dataclass(frozen=True)
class InputShape:
    """A named (batch, sequence) shape of one program kind, as the
    reference's: ``launch/specs.py`` builds a train, prefill or decode
    program for it."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """IMPALA learner/optimizer hyperparameters (defaults: IMPALA Table G.1)."""
    optimizer: str = "rmsprop"
    learning_rate: float = 6e-4
    rmsprop_eps: float = 0.01
    rmsprop_decay: float = 0.99
    rmsprop_momentum: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    adam_eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 40.0             # global-norm clip, IMPALA default
    lr_schedule: str = "linear"         # linear anneal to 0, IMPALA default
    total_steps: int = 100_000
    warmup_steps: int = 0

    # IMPALA loss weights (Table G.1)
    baseline_cost: float = 0.5
    entropy_cost: float = 0.01
    discount: float = 0.99
    vtrace_rho_clip: float = 1.0
    vtrace_c_clip: float = 1.0

    # CLEAR cloning costs on replayed rows (active only when the batch
    # carries an is_replay mask — i.e. behind a ReplaySource)
    clear_policy_cost: float = 0.0
    clear_value_cost: float = 0.0

    unroll_length: int = 80
    batch_size: int = 32
    num_actors: int = 48

    seed: int = 0
