"""Public wrappers for the hand-written kernels.

Each wrapper dispatches on where its tensors lie. On the CPU it runs the
kernel's plain version (``ref.py``). On CUDA it checks what the kernel
takes, launches it on the current stream, and raises on anything else:
there is no fallback from a CUDA tensor to the plain version, and a kernel
that fails to build is an error. Each launch adds one to the kernel's
count in ``stats()``, so a run can show that it went through the kernel.
Under CUDA graph capture a wrapper launches nothing: it records the
launch into the graph, and counts it in ``take_captured()``; the graph's
owner adds those counts to ``stats()`` at every replay
(``record_replay``), when the kernels do launch.

The kernels have no backward, as the reference's ``pallas_call``s have
none: on CUDA the attention and SSD wrappers raise when autograd would
need one (grad mode on and an input that requires grad), rather than
return outputs with no history. The differentiable paths are
``ssd_chunk_trainable`` here and ``models.attention``'s flash-attention
Function: the kernel forward, the VJP of the plain version backward.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Dict, Sequence

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref as _ref

_launches: Dict[str, int] = {"vtrace": 0, "flash_attention": 0,
                             "decode_attention": 0, "ssd_chunk": 0}
# launches recorded into CUDA graphs under capture, by kernel
_captured: Dict[str, int] = dict.fromkeys(_launches, 0)


def stats() -> Dict[str, int]:
    """Kernel launches since the last ``reset_stats()``, by kernel."""
    return dict(_launches)


def reset_stats() -> None:
    for name in _launches:
        _launches[name] = 0
        _captured[name] = 0


def _count(name) -> None:
    """One launch of kernel ``name``, or its record into the CUDA graph
    that the current stream is capturing."""
    if torch.cuda.is_current_stream_capturing():
        _captured[name] += 1
    else:
        _launches[name] += 1


def take_captured() -> Dict[str, int]:
    """The launches recorded into CUDA graphs since the last call, by
    kernel; zeroes them."""
    out = dict(_captured)
    for name in _captured:
        _captured[name] = 0
    return out


def record_replay(launches: Dict[str, int]) -> None:
    """Add a CUDA graph replay's launches (``take_captured()`` right after
    its capture) to ``stats()``."""
    for name, n in launches.items():
        _launches[name] += n


_fns: Dict[str, Callable[..., int]] = {}


def _kernel_fn(name, symbol, argtypes, restype=ctypes.c_int):
    """Function ``symbol`` of kernel ``name``'s library, typed once and
    cached, so that a call looks it up in one dict."""
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(_build.load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        _fns[symbol] = fn
    return fn


def _refuse_grad(name, tensors, instead):
    """Raise if autograd would need the kernel's backward, which it does
    not have: grad mode is on and an input requires grad."""
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in tensors):
        raise RuntimeError(
            f"{name} kernel: an input requires grad and the kernel has no "
            f"backward; call it under torch.no_grad(), or use {instead}")


def _launch(device, fn, *args):
    """``fn(*args, stream)`` on ``device``'s current stream, with
    ``device`` made the current device for the call if it is not already
    (a kernel launches on the calling thread's current device)."""
    if torch.cuda.current_device() == device.index:
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def _threshold(x):
    return math.inf if x is None else float(x)


_VTRACE_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
                    + [ctypes.c_float] * 3 + [ctypes.c_int] * 2
                    + [ctypes.c_void_p])
_VTRACE_MAX_WARPS = 16         # W at most: 512 threads a block
_VTRACE_MAX_ROWS = 16          # L at most: the rows one thread holds
_vtrace_chunks: Dict[str, int] = {"warps": 0, "rows": 0}


def vtrace_chunks(t):
    """(W, L) of the V-trace kernel for ``t`` rows: each block has W warps,
    each warp a chunk of L consecutive rows held in registers. L is the
    least of 1, 2, 4, 8, 16 with 16 L >= T (16 beyond T = 256) and W =
    ceil(T / L), at most 16; a T beyond W L = 256 is walked in segments of
    256 rows from the last. ``csrc/vtrace.cu`` says why."""
    rows = 1
    while rows < _VTRACE_MAX_ROWS and rows * _VTRACE_MAX_WARPS < t:
        rows *= 2
    return max(1, min(_VTRACE_MAX_WARPS, -(-t // rows))), rows


def last_vtrace_chunks():
    """(W, L) with which ``vtrace_from_importance_weights_kernel`` last
    launched its kernel; (0, 0) before its first launch."""
    return _vtrace_chunks["warps"], _vtrace_chunks["rows"]


def vtrace_from_importance_weights_kernel(
        log_rhos, discounts, rewards, values, bootstrap_value, *,
        clip_rho_threshold=1.0, clip_c_threshold=1.0,
        clip_pg_rho_threshold=1.0):
    """V-trace with the whole computation in one launch of the CUDA kernel
    ``csrc/vtrace.cu``, a chunked scan over T cut by ``vtrace_chunks``
    (drop-in for ``core.vtrace.vtrace_from_importance_weights``). log_rhos,
    discounts, rewards, values: (T, B) float32; bootstrap_value: (B,).
    ``None`` thresholds mean no clipping. Returns VTraceReturns(vs,
    pg_advantages), with no gradient."""
    from repro_torch.core.vtrace import VTraceReturns

    args = (log_rhos, discounts, rewards, values, bootstrap_value)
    if all(x.device.type == "cpu" for x in args):
        return VTraceReturns(*_ref.ref_vtrace_from_importance_weights(
            *args, clip_rho_threshold=clip_rho_threshold,
            clip_c_threshold=clip_c_threshold,
            clip_pg_rho_threshold=clip_pg_rho_threshold))

    device = values.device
    if device.type != "cuda" or any(x.device != device for x in args):
        raise ValueError("vtrace kernel: all inputs must lie on one CUDA "
                         f"device, got {[str(x.device) for x in args]}")
    if any(x.dtype != torch.float32 for x in args):
        raise TypeError("vtrace kernel takes float32, got "
                        f"{[x.dtype for x in args]}")
    if values.dim() != 2:
        raise ValueError(f"vtrace kernel: values must be (T, B), "
                         f"got {tuple(values.shape)}")
    t, b = values.shape
    if any(x.shape != (t, b) for x in args[:4]) \
            or bootstrap_value.shape != (b,):
        raise ValueError("vtrace kernel: shapes must be (T, B) x4 and (B,), "
                         f"got {[tuple(x.shape) for x in args]}")
    if not all(x.is_contiguous() for x in args):
        raise ValueError("vtrace kernel: inputs must be contiguous")

    warps, rows = vtrace_chunks(t)
    vs = torch.empty_like(values)
    pg_advantages = torch.empty_like(values)
    err = _launch(
        device, _kernel_fn("vtrace", "vtrace_from_importance_weights",
                           _VTRACE_ARGTYPES),
        *(x.data_ptr() for x in args), vs.data_ptr(),
        pg_advantages.data_ptr(), t, b, _threshold(clip_rho_threshold),
        _threshold(clip_c_threshold), _threshold(clip_pg_rho_threshold),
        warps, rows)
    if err != 0:
        raise RuntimeError(f"vtrace kernel launch failed: CUDA error {err}")
    _count("vtrace")
    _vtrace_chunks.update(warps=warps, rows=rows)
    return VTraceReturns(vs, pg_advantages)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

_ATTN_DTYPES = (torch.float32, torch.bfloat16)
ATTN_HEAD_DIMS = (64, 80, 128, 256)    # what the .cu is compiled for
_FLASH_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong] * 12 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_void_p])
_DECODE_ARGTYPES = ([ctypes.c_void_p] * 5
                    + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong]
                    + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 10
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_float]
                    + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)
_SPLIT_SLOTS = 32              # decode attention ranges are multiples of it
_DECODE_ROWS = 4               # query heads a decode attention block holds
_sm_counts: Dict[int, int] = {}
# (splits, range) of decode attention's last launch
_decode_split: Dict[str, int] = {"splits": 0, "range": 0}


def _check_attn(name, tensors: Sequence[torch.Tensor],
                vecs: Sequence[int]):
    """Device, type, head_dim and layout checks shared by both attention
    kernels: one CUDA device, one type of the two the kernels take, the
    head_dim axis contiguous, and every row start of ``tensors[i]`` aligned
    to ``vecs[i]`` elements (the kernels' vector loads and 16-byte copies).
    """
    device = tensors[0].device
    if device.type != "cuda" or any(x.device != device for x in tensors):
        raise ValueError(f"{name} kernel: all inputs must lie on one CUDA "
                         f"device, got {[str(x.device) for x in tensors]}")
    dtype = tensors[0].dtype
    if dtype not in _ATTN_DTYPES or any(x.dtype != dtype for x in tensors):
        raise TypeError(f"{name} kernel takes float32 or bfloat16 (all "
                        f"alike), got {[x.dtype for x in tensors]}")
    hd = tensors[0].shape[-1]
    if hd not in ATTN_HEAD_DIMS:
        raise ValueError(f"{name} kernel: head_dim {hd} is not one of "
                         f"{ATTN_HEAD_DIMS}")
    esize = tensors[0].element_size()
    for x, vec in zip(tensors, vecs):
        st = x.stride()
        # gcd(*strides) % vec == 0: every stride is a multiple of vec
        if st[-1] != 1 or math.gcd(*st[:-1]) % vec \
                or x.data_ptr() % (vec * esize):
            raise ValueError(f"{name} kernel: head_dim must be contiguous "
                             f"and rows aligned to {vec} elements, got "
                             f"strides {st}")
    return device


def flash_attention(q, k, v, *, scale=None, causal=True, window=0,
                    softcap=0.0, q_offset=0):
    """Flash attention forward on the CUDA kernel ``csrc/flash_attention.cu``
    (the reference's ``kernels.ops.flash_attention``). q: (B,H,Sq,hd); k, v:
    (B,K,Sk,hd) with H % K == 0, any strides whose hd axis is contiguous
    (transposed views of (B,S,H,hd) activations go in without a copy).
    Query row i sits at position ``q_offset + i`` of the keys' sequence,
    which the causal mask and the window read (the reference's kernel is
    q_offset 0 and Sq = Sk; a rank of a sequence split over its queries
    passes its share of the queries and every key). float32 (CUDA cores)
    or bf16 (tensor cores; rows 16-byte aligned), hd 64, 80, 128 or 256,
    any Sq and Sk. Returns (B,H,Sq,hd) in q's type, laid out like q. CPU
    tensors take the plain version."""
    if q.is_cpu and k.is_cpu and v.is_cpu:
        return _ref.ref_flash_attention(q, k, v, scale=scale, causal=causal,
                                        window=window, softcap=softcap,
                                        q_offset=q_offset)
    # float32 rows: 4-element vector loads; bf16 rows: 16-byte cp.async
    vec = 8 if q.dtype == torch.bfloat16 else 4
    device = _check_attn("flash_attention", (q, k, v), (vec,) * 3)
    _refuse_grad("flash_attention", (q, k, v),
                 "models.attention.attn_apply(impl='kernel')")
    b, h, s, hd = q.shape
    kheads, sk = k.shape[1], k.shape[2]
    if k.shape != (b, kheads, sk, hd) or v.shape != k.shape \
            or kheads == 0 or h % kheads or sk == 0:
        raise ValueError("flash_attention kernel: q (B,H,Sq,hd) and k, v "
                         "(B,K,Sk,hd) with H % K == 0 and Sk > 0, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q_offset < 0:
        raise ValueError(f"flash_attention kernel: q_offset {q_offset} < 0")
    if scale is None:
        scale = hd ** -0.5
    out = torch.empty_like(q)
    err = _launch(
        device, _kernel_fn("flash_attention", "flash_attention_forward",
                           _FLASH_ARGTYPES),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), b, h, kheads, s, sk, int(q_offset),
        hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], float(scale), int(bool(causal)),
        int(window or 0), float(softcap or 0.0))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    _count("flash_attention")
    return out


def decode_splits(b, h, kh, slots, sms=132):
    """(splits, range): how decode attention cuts a cache of ``slots``
    slots for ``b`` rows of ``h`` query heads on ``kh`` KV heads. One range
    per (row, KV head, group of up to four query heads) gives the base
    count of blocks. Ranges are ``range`` slots, a multiple of 32; they
    cover the cache with none empty; and splits times the base count
    reaches two blocks per SM (``sms``, 132 on an H100) wherever the cache
    has enough 32-slot pieces, else every piece is its own range."""
    blocks = kh * b * -(-(h // kh) // _DECODE_ROWS)
    pieces = -(-slots // _SPLIT_SLOTS)
    want = -(-2 * sms // blocks)
    span = max(1, pieces // want) * _SPLIT_SLOTS
    return -(-slots // span), span


def last_decode_split():
    """(splits, range) with which ``decode_attention`` last launched its
    kernel; (0, 0) before its first launch."""
    return _decode_split["splits"], _decode_split["range"]


def _sm_count(device):
    n = _sm_counts.get(device.index)
    if n is None:
        n = _sm_counts[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def decode_attention(q, k, v, slot_pos, pos, *, scale=None, softcap=0.0,
                     window=0):
    """One query token per row against its KV cache, on the CUDA kernel
    ``csrc/decode_attention.cu`` (the reference's
    ``kernels.ops.decode_attention``). q: (B,H,hd); k, v: (B,K,S,hd) with
    any strides whose hd axis is contiguous and rows 16-byte aligned: the
    model's (B,S,K,hd) cache goes in as a transposed view, without a copy.
    slot_pos: int32 (S,) or (B,S); pos: an int or an int32 tensor, scalar
    or (B,). The slots are split into ranges (``decode_splits``) whose
    partial states a second kernel merges, in the same call. Returns
    (B,H,hd) in q's type. CPU tensors take the plain version."""
    tensors = [x for x in (q, k, v, slot_pos, pos)
               if isinstance(x, torch.Tensor)]
    if all(x.is_cpu for x in tensors):
        return _ref.ref_decode_attention(q, k, v, slot_pos, pos, scale=scale,
                                         softcap=softcap, window=window)
    hd = q.shape[-1]
    # q: one lane loads hd/32 elements of a head row at once (at hd 80, 4
    # in 20 of the warp's 32 lanes); k, v: 16-byte cp.async pieces
    piece = 16 // q.element_size()
    device = _check_attn("decode_attention", (q, k, v),
                         (hd // 32 if hd % 32 == 0 else 4, piece, piece))
    _refuse_grad("decode_attention", (q, k, v),
                 "the plain decode path (impl='xla')")
    b, h, _ = q.shape
    kheads, s = k.shape[1], k.shape[2]
    if k.shape != (b, kheads, s, hd) or v.shape != k.shape \
            or kheads == 0 or h % kheads or s == 0:
        raise ValueError("decode_attention kernel: q (B,H,hd) and k, v "
                         "(B,K,S,hd) with H % K == 0 and S > 0, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not isinstance(slot_pos, torch.Tensor) or slot_pos.device != device \
            or slot_pos.dtype != torch.int32 \
            or slot_pos.shape not in ((s,), (b, s)) \
            or slot_pos.stride(-1) != 1:
        raise ValueError("decode_attention kernel: slot_pos must be an int32 "
                         f"(S,) or (B,S) tensor on {device} with contiguous "
                         "slots")
    slot_stride = slot_pos.stride(0) if slot_pos.dim() == 2 else 0
    if isinstance(pos, torch.Tensor):
        if pos.device != device or pos.dtype != torch.int32 \
                or pos.numel() not in (1, b) or pos.dim() > 1:
            raise ValueError("decode_attention kernel: pos must be an int or "
                             f"an int32 scalar or (B,) tensor on {device}")
        pos_ptr, pos_stride, pos_scalar = (
            pos.data_ptr(), pos.stride(0) if pos.numel() > 1 else 0, 0)
    else:
        pos_ptr, pos_stride, pos_scalar = None, 0, int(pos)
    if scale is None:
        scale = hd ** -0.5
    splits, span = decode_splits(b, h, kheads, s, _sm_count(device))
    out = torch.empty((b, h, hd), dtype=q.dtype, device=device)
    ws = None
    if splits > 1:   # each split's (m, l) and float32 acc
        ws = torch.empty(b * h * splits * (hd + 2), dtype=torch.float32,
                         device=device)
    err = _launch(
        device, _kernel_fn("decode_attention", "decode_attention_forward",
                           _DECODE_ARGTYPES),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        slot_pos.data_ptr(), slot_stride, pos_ptr, pos_stride, pos_scalar,
        int(q.dtype == torch.bfloat16), b, h, kheads, s, hd,
        *q.stride()[:2], k.stride(0), k.stride(2), k.stride(1), v.stride(0),
        v.stride(2), v.stride(1), *out.stride()[:2], float(scale),
        int(window or 0), float(softcap or 0.0), splits, span,
        None if ws is None else ws.data_ptr())
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    _count("decode_attention")
    _decode_split.update(splits=splits, range=span)
    return out


# ---------------------------------------------------------------------------
# Mamba2 SSD chunk
# ---------------------------------------------------------------------------

SSD_HEAD_DIMS = (16, 32, 64)            # what the .cu is compiled for
_SSD_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                 + [ctypes.c_longlong] * 13 + [ctypes.c_void_p] * 3)
_ssd_smem: Dict[tuple, int] = {}
# (state floats, flag words) of the kernel's workspaces, by launch shape
_ssd_sizes: Dict[tuple, tuple] = {}
# per device: the kernel's flags, zero between launches (every launch
# leaves them zero), grown when a launch needs more
_ssd_flags: Dict[int, torch.Tensor] = {}


def ssd_chunk_smem_bytes(length, n, p):
    """Bytes of shared memory a launch of the SSD chunk kernel at (L, N, P)
    needs, as the kernel's library computes them (built if needed);
    ``ssd_smem_bytes`` is its Python mirror."""
    key = (length, n, p)
    nbytes = _ssd_smem.get(key)
    if nbytes is None:
        fn = _kernel_fn("ssd_chunk", "ssd_chunk_smem_bytes",
                        [ctypes.c_int] * 3, ctypes.c_size_t)
        nbytes = _ssd_smem[key] = int(fn(length, n, p))
    return nbytes


def _ssd_workspaces(device, rows, length, n, p):
    """The SSD chunk kernel's workspaces for a launch of ``rows`` slices:
    a fresh ``states`` buffer (the state at each 64-row block's start,
    passed from the block that computes it to the block that reads it) and
    the device's flag words, which are zero between launches. Launches on
    one device must not overlap in time (the port runs one stream)."""
    key = (rows, length, n, p)
    sizes = _ssd_sizes.get(key)
    if sizes is None:
        sizes = _ssd_sizes[key] = (
            _kernel_fn("ssd_chunk", "ssd_chunk_state_floats",
                       [ctypes.c_int] * 4, ctypes.c_longlong)(
                           rows, length, n, p),
            _kernel_fn("ssd_chunk", "ssd_chunk_flag_words",
                       [ctypes.c_int] * 2, ctypes.c_longlong)(rows, length))
    floats, words = sizes
    flags = _ssd_flags.get(device.index)
    if flags is None or flags.numel() < words:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("ssd_chunk kernel: its flags must be allocated "
                               "before a CUDA graph capture; call it once at "
                               "this size (or larger) first")
        flags = _ssd_flags[device.index] = torch.zeros(
            words, dtype=torch.int32, device=device)
    return torch.empty(floats, dtype=torch.float32, device=device), flags


def ssd_chunk(c, b, xdt, da, h_prev):
    """One Mamba2 SSD chunk on the CUDA kernel ``csrc/ssd_chunk.cu`` (the
    reference's ``kernels.ops.ssd_chunk``), float32 in and out, in either
    of two layouts:

    * the reference's, one slice per (batch * head): c, b (BH,L,N); xdt
      (BH,L,P); da (BH,L,1); h_prev (BH,P,N) -> y (BH,L,P), h_new (BH,P,N);
    * the model's, whose H heads of a batch row share one B/C group that
      the kernel reads in place: c, b (B,L,N); xdt (B,L,H,P); da (B,L,H);
      h_prev (B,H,P,N) -> y (B,L,H,P), h_new (B,H,P,N).

    c, b and xdt may have any strides whose last axis is contiguous (rows
    16-byte aligned), da any strides; h_prev must be contiguous. P is 16,
    32 or 64 and N a multiple of 4. The kernel's blocks pass states to each
    other through two workspaces (``_ssd_workspaces``). CPU tensors take
    the plain version. No backward: ``ssd_chunk_trainable`` has one."""
    args = (c, b, xdt, da, h_prev)
    heads_form = xdt.dim() == 4
    if all(x.device.type == "cpu" for x in args):
        plain = _ref.ref_ssd_chunk_heads if heads_form else _ref.ref_ssd_chunk
        return plain(*args)

    device = h_prev.device
    if device.type != "cuda" or any(x.device != device for x in args):
        raise ValueError("ssd_chunk kernel: all inputs must lie on one CUDA "
                         f"device, got {[str(x.device) for x in args]}")
    if any(x.dtype != torch.float32 for x in args):
        raise TypeError("ssd_chunk kernel takes float32, got "
                        f"{[x.dtype for x in args]}")
    shapes = [tuple(x.shape) for x in args]
    if heads_form:
        bsz, l, heads, p = xdt.shape
        n = c.shape[-1]
        want = [(bsz, l, n), (bsz, l, n), (bsz, l, heads, p),
                (bsz, l, heads), (bsz, heads, p, n)]
        # (batch, head, position) strides
        x_st = (xdt.stride(0), xdt.stride(2), xdt.stride(1))
        da_st = (da.stride(0), da.stride(2), da.stride(1))
        y = torch.empty((bsz, l, heads, p), dtype=torch.float32,
                        device=device)
        y_st = (y.stride(0), y.stride(2), y.stride(1))
    else:
        bsz, l, n = c.shape
        heads, p = 1, xdt.shape[-1]
        want = [(bsz, l, n), (bsz, l, n), (bsz, l, p), (bsz, l, 1),
                (bsz, p, n)]
        x_st = (xdt.stride(0), 0, xdt.stride(1))
        da_st = (da.stride(0), 0, da.stride(1))
        y = torch.empty((bsz, l, p), dtype=torch.float32, device=device)
        y_st = (y.stride(0), 0, y.stride(1))
    if shapes != want or l == 0:
        raise ValueError(f"ssd_chunk kernel: shapes {shapes}, want {want} "
                         "with L >= 1")
    if p not in SSD_HEAD_DIMS or n % 4:
        raise ValueError(f"ssd_chunk kernel: head dim {p} not in "
                         f"{SSD_HEAD_DIMS} or state size {n} not a "
                         "multiple of 4")
    for x in (c, b, xdt):
        if x.stride(-1) != 1 or any(st % 4 for st in x.stride()[:-1]) \
                or x.data_ptr() % 16:
            raise ValueError("ssd_chunk kernel: c, b and xdt need a "
                             "contiguous last axis and rows aligned to 4 "
                             f"elements, got strides {x.stride()}")
    if not h_prev.is_contiguous():
        raise ValueError("ssd_chunk kernel: h_prev must be contiguous")
    _refuse_grad("ssd_chunk", args, "ssd_chunk_trainable")
    smem = ssd_smem_bytes(l, n, p)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"ssd_chunk kernel: L={l}, N={n} need {smem} bytes "
                         f"of shared memory, more than {MAX_SMEM_BYTES}")

    h_new = torch.empty_like(h_prev)
    states, flags = _ssd_workspaces(device, bsz * heads, l, n, p)
    err = _launch(
        device, _kernel_fn("ssd_chunk", "ssd_chunk_forward", _SSD_ARGTYPES),
        c.data_ptr(), b.data_ptr(), xdt.data_ptr(), da.data_ptr(),
        h_prev.data_ptr(), y.data_ptr(), h_new.data_ptr(), bsz * heads,
        heads, l, n, p, c.stride(0), c.stride(1), b.stride(0), b.stride(1),
        *x_st, *da_st, *y_st, states.data_ptr(), flags.data_ptr())
    if err != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed: CUDA error {err}")
    _count("ssd_chunk")
    return y, h_new


class _SSDChunk(torch.autograd.Function):
    """``ssd_chunk`` forward; backward the VJP of its plain version,
    recomputed from the saved inputs (the chunk is rematerialised, as
    flash attention rematerialises its scores)."""

    @staticmethod
    def forward(ctx, c, b, xdt, da, h_prev):
        ctx.save_for_backward(c, b, xdt, da, h_prev)
        return ssd_chunk(c, b, xdt, da, h_prev)

    @staticmethod
    def backward(ctx, dy, dh):
        saved = ctx.saved_tensors
        plain = (_ref.ref_ssd_chunk_heads if saved[2].dim() == 4
                 else _ref.ref_ssd_chunk)
        with torch.enable_grad():
            args = [x.detach().requires_grad_(need)
                    for x, need in zip(saved, ctx.needs_input_grad)]
            wanted = [x for x in args if x.requires_grad]
            grads = iter(torch.autograd.grad(plain(*args), wanted,
                                             (dy, dh)))
        return tuple(next(grads) if x.requires_grad else None for x in args)


def ssd_chunk_trainable(c, b, xdt, da, h_prev):
    """``ssd_chunk`` with a backward (the reference's
    ``kernels.ops.ssd_chunk_trainable``): the kernel on the forward (the
    plain version for CPU tensors), the VJP of the plain version on the
    backward, in either layout."""
    return _SSDChunk.apply(c, b, xdt, da, h_prev)


# ---------------------------------------------------------------------------
# launch geometry: Python mirrors of each kernel's launches
# ---------------------------------------------------------------------------

# An H100's limits on a launch: grid x, y and z; threads a block; dynamic
# shared memory a block (227 KB of the SM's 256 KB, after the opt-in)
GRID_X_MAX = 2 ** 31 - 1
GRID_YZ_MAX = 65535
BLOCK_THREADS_MAX = 1024
MAX_SMEM_BYTES = 232448

_FLASH_ROWS = 64               # query rows a flash-attention block owns
_FLASH_THREADS = 256           # both kernels: 8 warps
_DECODE_THREADS = 128          # 4 warps
_DECODE_COMBINE_THREADS = 128
_SSD_ROWS = 64                 # chunk positions a row block owns
_SSD_THREADS = 256


def ssd_smem_bytes(length, n, p):
    """Bytes of shared memory a launch of the SSD chunk kernel at (L, N,
    P) needs: the mirror of ``csrc/ssd_chunk.cu``'s ``layout``, in float32
    words, every offset a multiple of 4 (``chip_smoke.py`` holds it equal
    to the library's ``ssd_chunk_smem_bytes``)."""
    keys = 32
    lp = -(-length // _SSD_ROWS) * _SSD_ROWS
    n8 = -(-n // 8) * 8
    ns, xs = n8 + 4, p + 4
    w = 12 + lp
    c = w + lp
    state = c + _SSD_ROWS * ns
    planes = state + p * ns
    ring = planes + max(max(2 * keys * ns, 2 * n8 * (keys + 4))
                        + 2 * p * (keys + 4), 4 * 32 * 32)
    return 4 * (ring + 2 * keys * (ns + xs))


def _flash_smem(hd, bf16):
    if bf16:                   # tc::Cfg<HD>: K and V rings (+ Q at hd 256)
        keys, stride = (32 if hd == 256 else 64), hd + 8
        return 2 * (2 * 4 * keys * stride
                    + (0 if hd <= 128 else _FLASH_ROWS * stride))
    return 4 * (2 * _FLASH_ROWS * (hd + 4) + _FLASH_ROWS * 80)


def _decode_smem(hd, bf16):
    esize, tile = (2, 32) if bf16 else (4, 16)
    lanes = hd // 32 if hd % 32 == 0 else 4
    return max(2 * 3 * tile * hd * esize, 4 * 4 * 32 * lanes * 4)


def launch_geometry(kernel, **dims):
    """The launches one wrapper call makes, as its ``.cu`` makes them:
    a list of ((grid x, y, z), threads a block, dynamic shared memory
    bytes a block). Dims:

      vtrace            t, b
      flash_attention   b, h, sq, hd, bf16
      decode_attention  b, h, kh, s, hd, bf16 [, sms=132]
      ssd_chunk         rows (slices), l, n, p
    """
    if kernel == "vtrace":
        warps, _ = vtrace_chunks(dims["t"])
        return [((-(-dims["b"] // 32), 1, 1), 32 * warps, 0)]
    if kernel == "flash_attention":
        b, h, sq, hd, bf16 = (dims[k] for k in ("b", "h", "sq", "hd",
                                                "bf16"))
        tiles = -(-sq // _FLASH_ROWS)
        grid = (h, tiles, b) if bf16 else (tiles, h, b)
        return [(grid, _FLASH_THREADS, _flash_smem(hd, bf16))]
    if kernel == "decode_attention":
        b, h, kh, s, hd, bf16 = (dims[k] for k in ("b", "h", "kh", "s",
                                                   "hd", "bf16"))
        splits, _ = decode_splits(b, h, kh, s, dims.get("sms", 132))
        group = h // kh
        rows = 1 if group == 1 else _DECODE_ROWS
        out = [((kh, b, splits * -(-group // rows)), _DECODE_THREADS,
                _decode_smem(hd, bf16))]
        if splits > 1:
            out.append(((h, b, 1), _DECODE_COMBINE_THREADS, 0))
        return out
    if kernel == "ssd_chunk":
        rows, length = dims["rows"], dims["l"]
        return [((rows, -(-length // _SSD_ROWS) + 1, 1), _SSD_THREADS,
                 ssd_smem_bytes(length, dims["n"], dims["p"]))]
    raise ValueError(f"unknown kernel {kernel}")


def library_geometry(kernel, **dims):
    """The same launches as the built ``.cu`` reports them (its
    ``<kernel>_geometry`` export; the library is built if needed)."""
    out = (ctypes.c_longlong * 10)()
    if kernel == "vtrace":
        warps, _ = vtrace_chunks(dims["t"])
        n = _kernel_fn("vtrace", "vtrace_geometry", [ctypes.c_int] * 2
                       + [ctypes.c_void_p])(dims["b"], warps, out)
    elif kernel == "flash_attention":
        n = _kernel_fn("flash_attention", "flash_attention_geometry",
                       [ctypes.c_int] * 5 + [ctypes.c_void_p])(
            int(dims["bf16"]), dims["b"], dims["h"], dims["sq"], dims["hd"],
            out)
    elif kernel == "decode_attention":
        splits, _ = decode_splits(dims["b"], dims["h"], dims["kh"],
                                  dims["s"], dims.get("sms", 132))
        n = _kernel_fn("decode_attention", "decode_attention_geometry",
                       [ctypes.c_int] * 6 + [ctypes.c_void_p])(
            int(dims["bf16"]), dims["b"], dims["h"], dims["kh"], dims["hd"],
            splits, out)
    elif kernel == "ssd_chunk":
        n = _kernel_fn("ssd_chunk", "ssd_chunk_geometry",
                       [ctypes.c_int] * 4 + [ctypes.c_void_p])(
            dims["rows"], dims["l"], dims["n"], dims["p"], out)
    else:
        raise ValueError(f"unknown kernel {kernel}")
    if n < 0:
        raise ValueError(f"{kernel} kernel: not compiled for {dims}")
    return [(tuple(out[5 * i:5 * i + 3]), out[5 * i + 3], out[5 * i + 4])
            for i in range(n)]
