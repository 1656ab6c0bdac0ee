"""Roofline accounting on one NVIDIA H100, after the reference's
``launch/roofline.py``.

``kernel_roofline`` gives one launch of a hand-written kernel its FLOPs
(the matmul terms, 2 a multiply-add) and its least HBM traffic (every
operand read once, every output written once), by the reference's
formulas exactly; ``kernel_rooflines`` the same for every kernel an
(arch, input shape) reaches, with its launches a step; and
``inner_scan_corrections`` the reference's analytic FLOPs of the loops
inside one block or the loss. What differs from the reference is the
machine: ``roofline_s`` and ``bound`` read the H100's peaks
(``launch/mesh.py``), the peak of the type the operands are multiplied
in. A float32 kernel on the CUDA cores is bounded by 67 TFLOP/s, not by
the bf16 tensor cores' 989.

``bound(flops, nbytes, dtype)`` is the one function every bound in the
port reads: ``chip_smoke.py`` calls it with the work of the function a
wrapper computes (which may be more than the reference's kernel: K1's
wrapper fuses the deltas the reference computes outside ``vtrace_scan``),
and ``kernel_roofline`` with the reference's formulas.

``build_block_program`` is the port's counterpart of the reference's
block program: there XLA's cost analysis reads one lowered super-block;
here it is a callable that runs one super-block on this rank's slices
under the given mesh and rules (forward for serve and prefill, forward
plus a backward through remat for train), which ``launch/dryrun.py``
runs and measures.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig
from repro_torch.launch import mesh as mesh_lib

_TYPES = {torch.bfloat16: "bfloat16", torch.float16: "float16",
          torch.float32: "float32"}


def _shape(shape_name):
    return INPUT_SHAPES[shape_name] if isinstance(shape_name, str) \
        else shape_name


def peak_flops(dtype) -> float:
    """The card's peak FLOP/s for operands of ``dtype`` (a torch dtype,
    or "bfloat16", "float16", "float32", "tf32")."""
    name = _TYPES.get(dtype, dtype)
    if name not in mesh_lib.PEAK_FLOPS:
        raise ValueError(f"no peak for {dtype!r}; known: "
                         f"{sorted(mesh_lib.PEAK_FLOPS)}")
    return mesh_lib.PEAK_FLOPS[name]


def bound(flops: float, nbytes: float, dtype) -> Dict[str, float]:
    """The least time the card could take for ``flops`` operations on
    ``dtype`` operands and ``nbytes`` of HBM traffic: the larger of the
    two terms, and which one it is ("compute" or "memory")."""
    compute_s = flops / peak_flops(dtype)
    memory_s = nbytes / mesh_lib.HBM_BW
    return {"compute_s": compute_s, "memory_s": memory_s,
            "roofline_s": max(compute_s, memory_s),
            "bound": "compute" if compute_s >= memory_s else "memory"}


# ---------------------------------------------------------------------------
# analytic inner-scan corrections (FLOPs), the reference's formulas
# ---------------------------------------------------------------------------

def _count(cfg, kinds) -> int:
    return sum(1 for m, _ in cfg.block_pattern if m in kinds) \
        * cfg.num_groups


def inner_scan_corrections(cfg: ModelConfig, shape_name,
                           chips: int) -> Dict[str, float]:
    """Global FLOPs of the loops inside one block or the loss that a
    count of each loop body once leaves out, by source (the reference's
    closed forms, per layer, global tokens B*S):

      attn_chunked: kv_step ~ 4*B*H*cq*ckv*hd   -> x (nq*nkv - 1)
      loss_chunks:  chunk  ~ 6*B*c*d*V (fwd+recompute+bwd) -> x (nchunk-1)
      mamba_chunks: chunk  ~ B*L^2*H*(N+P) + 4*B*L*H*P*N   -> x (nc-1)
      mlstm_chunks: chunk  ~ 4*B*L^2*H*dh                  -> x (nc-1)
      slstm_steps:  step   ~ 8*B*H*dh^2                    -> x (S-1)
    """
    del chips
    ishape = _shape(shape_name)
    b, s, kind = ishape.global_batch, ishape.seq_len, ishape.kind
    out = {k: 0.0 for k in ("attn_chunked", "loss_chunks", "mamba_chunks",
                            "mlstm_chunks", "slstm_steps")}
    if kind == "decode":
        return out
    hd, h, d = cfg.resolved_head_dim, cfg.num_heads, cfg.d_model
    n_attn = _count(cfg, ("attn", "local_attn", "swa_attn"))
    n_x = _count(cfg, ("xattn",))
    if cfg.shared_attn_every:
        n_attn += cfg.num_groups
    if cfg.attn_impl in ("xla_chunked", "xla_chunked_skip", "kernel",
                         "pallas"):
        cq = min(cfg.attn_chunk, s)
        nq = s // cq
        out["attn_chunked"] += n_attn * (nq * nq - 1) * 4.0 * b * h * cq \
            * cq * hd
        if n_x:
            sv = cfg.vision_seq
            ckv = min(cfg.attn_chunk, sv)
            out["attn_chunked"] += n_x * (nq * (sv // ckv) - 1) * 4.0 * b \
                * h * cq * ckv * hd
    if kind == "train":
        c = min(512, s)
        out["loss_chunks"] = (s // c - 1) * 6.0 * b * c * d * cfg.vocab_size
    mult = 3.0 if kind == "train" else 1.0     # fwd + recompute + bwd
    n_mamba = _count(cfg, ("mamba",))
    if n_mamba:
        nh = cfg.ssm_expand * d // cfg.ssm_head_dim
        p_, n_ = cfg.ssm_head_dim, cfg.ssm_state
        L = min(cfg.ssm_chunk, s)
        per_chunk = b * L * L * nh * (n_ + p_) + 4.0 * b * L * nh * p_ * n_
        out["mamba_chunks"] = n_mamba * (s // L - 1) * per_chunk * mult
    n_mlstm = _count(cfg, ("mlstm",))
    if n_mlstm:
        dh = d // cfg.num_heads
        L = min(cfg.xlstm_chunk, s)
        out["mlstm_chunks"] = n_mlstm * (s // L - 1) * 4.0 * b * L * L \
            * cfg.num_heads * dh * mult
    n_slstm = _count(cfg, ("slstm",))
    if n_slstm:
        dh = d // cfg.num_heads
        out["slstm_steps"] = n_slstm * (s - 1) * 8.0 * b * cfg.num_heads \
            * dh * dh * mult
    return out


# ---------------------------------------------------------------------------
# per-kernel rooflines: one launch
# ---------------------------------------------------------------------------

def kernel_roofline(kernel: str, *, dtype_bytes: int = 2,
                    dtype: Optional[str] = None, **dims) -> Dict[str, float]:
    """One launch of ``kernel`` on one H100: FLOPs (the matmul terms) and
    the least bytes, by the reference's formulas, then ``roofline_s`` and
    ``bound`` against the peak of ``dtype``, the type the operands are
    multiplied in (default: bfloat16 for 2-byte operands, else float32;
    V-trace is float32).

    Dims per kernel (the reference's):
      flash_attention   b, h, kh, s, hd [, window, causal=True]
      decode_attention  b, h, kh, s, hd
      ssd_chunk         bh, l, n, p
      vtrace            t, b
    flash_attention also takes ``sq`` queries at ``q_offset`` into the s
    keys (the context-parallel split, which the reference's kernel does
    not take): the visited (query, key) pairs are then counted row by
    row, and q and o are ``sq`` rows."""
    if kernel == "flash_attention":
        b, h, kh = dims["b"], dims["h"], dims["kh"]
        s, hd = dims["s"], dims["hd"]
        window = dims.get("window", 0)
        causal = dims.get("causal", True)
        if "sq" in dims or "q_offset" in dims:
            sq, off = dims.get("sq", s), dims.get("q_offset", 0)
            pairs = 0
            for i in range(sq):
                live = min(off + i + 1, s) if causal else s
                pairs += min(live, window) if window else live
            flops = 4.0 * b * h * pairs * hd
            bytes_ = dtype_bytes * (2 * b * h * sq * hd + 2 * b * kh * s * hd)
        else:
            # visited (q, kv) pairs: causal halves the square; a sliding
            # window caps each query's kv span
            s_eff = min(window, s) if window else (s + 1) / 2.0
            if not causal:
                s_eff = s
            flops = 4.0 * b * h * s * s_eff * hd            # qk^T + pv
            bytes_ = dtype_bytes * (2 * b * h * s * hd       # q + o
                                    + 2 * b * kh * s * hd)   # k + v
    elif kernel == "decode_attention":
        b, h, kh = dims["b"], dims["h"], dims["kh"]
        s, hd = dims["s"], dims["hd"]
        flops = 4.0 * b * h * s * hd
        bytes_ = dtype_bytes * (2 * b * kh * s * hd          # streamed k + v
                                + 2 * b * h * hd)            # q + o
    elif kernel == "ssd_chunk":
        bh, L, n, p = dims["bh"], dims["l"], dims["n"], dims["p"]
        # G = C B^T (2L^2n); y_diag = (G.decay) X (2L^2p);
        # state update + y_off (2Lnp each)
        flops = bh * (2.0 * L * L * (n + p) + 4.0 * L * n * p)
        bytes_ = dtype_bytes * bh * (2 * L * n + 2 * L * p + 2 * p * n + L)
    elif kernel == "vtrace":
        t, b = dims["t"], dims["b"]
        flops = 3.0 * t * b                              # one fma + mul a cell
        bytes_ = 4 * 3 * t * b                           # deltas, dcs, out
        dtype = dtype or "float32"
    else:
        raise ValueError(f"unknown kernel {kernel}")
    if dtype is None:
        dtype = "bfloat16" if dtype_bytes == 2 else "float32"
    terms = bound(flops, bytes_, dtype)
    return {"flops": flops, "bytes": bytes_,
            "intensity": flops / bytes_ if bytes_ else 0.0,
            "roofline_s": terms["roofline_s"], "bound": terms["bound"],
            "dtype": dtype}


def kernel_rooflines(cfg: ModelConfig, shape_name) -> Dict[str, Dict]:
    """Every kernel with a hot path in this (cfg, input shape): its
    one-launch roofline and ``calls_per_step`` (layers x inner chunks x
    passes), as the reference counts them. Archs without the mixer omit
    the kernel."""
    ishape = _shape(shape_name)
    b, s, kind = ishape.global_batch, ishape.seq_len, ishape.kind
    dtype = cfg.dtype
    dtype_bytes = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    hd = cfg.resolved_head_dim
    n_attn = _count(cfg, ("attn", "local_attn", "swa_attn"))
    if cfg.shared_attn_every:
        n_attn += cfg.num_groups
    n_mamba = _count(cfg, ("mamba",))
    out: Dict[str, Dict] = {}
    if n_attn:
        if kind == "decode":
            rl = kernel_roofline("decode_attention", dtype_bytes=dtype_bytes,
                                 dtype=dtype, b=b, h=cfg.num_heads,
                                 kh=cfg.num_kv_heads, s=s, hd=hd)
            rl["calls_per_step"] = n_attn
            out["decode_attention"] = rl
        else:
            window = cfg.sliding_window if all(
                m in ("swa_attn", "local_attn") for m, _ in cfg.block_pattern
                if m.endswith("attn")) else 0
            rl = kernel_roofline("flash_attention", dtype_bytes=dtype_bytes,
                                 dtype=dtype, b=b, h=cfg.num_heads,
                                 kh=cfg.num_kv_heads, s=s, hd=hd,
                                 window=window)
            rl["calls_per_step"] = n_attn * (3 if kind == "train" else 1)
            out["flash_attention"] = rl
    if n_mamba and kind != "decode":
        nh = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
        L = min(cfg.ssm_chunk, s)
        rl = kernel_roofline("ssd_chunk", dtype_bytes=4,  # fp32 state math
                             bh=b * nh, l=L, n=cfg.ssm_state,
                             p=cfg.ssm_head_dim)
        rl["calls_per_step"] = n_mamba * (s // L) * (3 if kind == "train"
                                                     else 1)
        out["ssd_chunk"] = rl
    if kind == "train":
        rl = kernel_roofline("vtrace", t=s, b=b)
        rl["calls_per_step"] = 1
        out["vtrace"] = rl
    return out


# ---------------------------------------------------------------------------
# the block program: one super-block, run
# ---------------------------------------------------------------------------

def _local_rows(mesh, rules, b, s):
    """This rank's (rows, sequence) of a (B, S, d) residual under the
    rules: its data block of the rows, and its sequence shard where the
    rules split the residual over "model" (sequence parallel)."""
    from repro_torch.launch.specs import _data_parts
    rows = b // _data_parts(mesh, b)
    seq_split = rules.get("act_seq") == "model" and mesh.model > 1 \
        and s % mesh.model == 0
    return rows, (s // mesh.model if seq_split else s), seq_split


def build_block_program(cfg: ModelConfig, shape_name, mesh, rules, *,
                        seed: int = 0):
    """One super-block (and Zamba2's shared block after it) of ``cfg`` on
    this rank of ``mesh`` under ``rules``, with its inputs: returns
    ``(fn, args)``, ``fn(*args)`` running

      decode   one token through the block against its cache (written in
               place), under no_grad: ``(x, cache)``;
      prefill  the shape's whole sequence with the block's cache built,
               under no_grad: ``(y, cache)``;
      train    the block's forward as one remat region and the backward of
               ``sum(y) * 1e-6`` through it: the gradients of the block's
               leaves (this rank's slices) and of ``x``.

    The block's leaves are this rank's slices of a one-group model
    (``specs.rank_params``), the activations this rank's rows and
    sequence shard, every input ``0.01 * normal`` from ``seed``."""
    from repro_torch.launch import specs
    from repro_torch.models import blocks
    from repro_torch.models.common import dtype_of, remat, use_rules
    from repro_torch.models.model import SHARED_PATTERN

    ishape = _shape(shape_name)
    b, s, kind = ishape.global_batch, ishape.seq_len, ishape.kind
    one = dataclasses.replace(cfg, num_groups=1)
    params = specs.rank_params(one, mesh, rules, seed=seed)
    bp = params["blocks"][0]
    shared = params["shared"] if cfg.shared_attn_every else None
    dtype, dev = dtype_of(cfg), mesh.device
    gen = specs._generator(seed + 1, dev)
    rows, s_local, seq_split = _local_rows(mesh, rules, b, s)
    vis = None
    if cfg.vision_seq and kind != "decode":
        vis = specs._materialise((rows, cfg.vision_seq, cfg.d_model), dtype,
                                 gen, dev)

    if kind == "decode":
        x = specs._materialise((rows, 1, cfg.d_model), dtype, gen, dev)
        cache = specs.cache_specs(one, mesh, rules, b, s, seed=seed + 2)
        cache = {k: _first(v) for k, v in cache.items()}

        def decode_fn(bp, shared, x, cache, pos):
            with torch.no_grad(), use_rules(mesh, rules):
                x, _ = blocks.block_decode(bp, x, cache["block"], cfg=cfg,
                                           pos=pos)
                if shared is not None:
                    x, _ = blocks.block_decode(shared, x, cache["shared"],
                                               cfg=cfg, pos=pos,
                                               pattern=SHARED_PATTERN)
            return x, cache

        return decode_fn, (bp, shared, x, cache, s - 1)

    x = specs._materialise((rows, s_local, cfg.d_model), dtype, gen, dev)
    positions = torch.arange(s, device=dev)
    kw = dict(cfg=cfg, positions=positions, seq_split=seq_split)

    if kind == "prefill":
        def prefill_fn(bp, shared, x, vis):
            with torch.no_grad(), use_rules(mesh, rules):
                y, _, cache = blocks.block_apply(
                    bp, x, vision=vis, build_cache=True, seq_len=s,
                    dtype=x.dtype, **kw)
                cache = {"block": cache}
                if shared is not None:
                    y, _, cache["shared"] = blocks.block_apply(
                        shared, y, pattern=SHARED_PATTERN, build_cache=True,
                        seq_len=s, dtype=x.dtype, **kw)
            return y, cache

        return prefill_fn, (bp, shared, x, vis)

    def train_fn(bp, shared, x, vis):
        leaves = list(bp.parameters()) + (
            list(shared.parameters()) if shared is not None else [])
        x = x.detach().requires_grad_()

        def apply(x):
            y, _, _ = blocks.block_apply(bp, x, vision=vis, **kw)
            if shared is not None:
                y, _, _ = blocks.block_apply(shared, y,
                                             pattern=SHARED_PATTERN, **kw)
            return y

        with use_rules(mesh, rules):
            y = remat(apply, x)
            loss = y.float().sum() * 1e-6
            grads = torch.autograd.grad(loss, leaves + [x])
        return grads[:-1], grads[-1]

    return train_fn, (bp, shared, x, vis)


def _first(tree):
    """A cache tree's leaves without their leading groups axis."""
    if isinstance(tree, dict):
        return {k: _first(v) for k, v in tree.items()}
    return tree[0]
