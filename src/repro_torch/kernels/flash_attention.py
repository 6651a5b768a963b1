"""CUDA wrapper for the flash-attention forward (causal / windowed, GQA).

Replaces the Pallas kernel ``flash_attention``
(``src/repro/kernels/flash_attention.py``). The source is
``csrc/flash_attention.cu``; its header says what bounds the kernel on the
H100 (operations: two products per tile) and how its two kernels meet
them: bf16 runs ``flash_attention_wgmma_kernel`` on the tensor cores (TMA
loads into a K/V ring, ``wgmma`` products, P split into bf16 hi + lo for
the P.V product; 64-key stages where dh or dhv is past 128, and 64-row
blocks of one consumer warpgroup where dhv is); fp32 runs
``flash_attention_kernel``, fp32 FMA on the CUDA cores. Head dims run to
256 (Gemma3's 256, DeepSeek's 192 / 128), as the TPU kernel takes the whole
head dimension as one block. Unlike the TPU wrapper, q, k and v are read in
their (B, S, H, dh) layout through strides, with no transpose on the host. This wrapper
takes CUDA tensors only; ``kernels.ops`` sends CPU tensors to
``kernels.ref.flash_attention_ref``.

``flash_attention_bwd`` is the gradient of the same function, from
``csrc/flash_attention_bwd.cu`` (no Pallas counterpart: the reference
trains through plain attention and lets autodiff take its gradient): a dq
kernel that also recomputes each row's log-sum-exp and rowsum(dout * out),
then a dk / dv kernel, fp32 FMA on the CUDA cores for both dtypes, with no
atomics (each output element is summed by one block, so it is
deterministic). ``kernels.ops.flash_attention`` is the autograd Function
over the two.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_Y_MAX = 65535
_WGMMA_ROWS = 128   # query rows per block of the bf16 kernel (64 where dhv > 128)

LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}

_fn = None
_bwd_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_int64] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bwd_entry():
    global _bwd_fn
    if _bwd_fn is None:
        fn = _build.load("flash_attention_bwd").flash_attention_bwd
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                       + [ctypes.c_int64] * 15
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def _tma_strides(t: torch.Tensor) -> tuple[int, int, int] | None:
    """(b, s, h) element strides under which TMA reads ``t`` (B, S, H, d)
    in place, or None. TMA needs a 16-byte-aligned base, strides that are
    multiples of 16 bytes and, here, strides that grow outwards (h, s, b);
    a dimension of size 1 is never stepped, so it takes the extent of the
    dimension inside it."""
    B, S, H, d = t.shape
    sb, ss, sh = t.stride()[:3]
    sh = sh if H > 1 else -(-d // 8) * 8
    ss = ss if S > 1 else sh * H
    sb = sb if B > 1 else ss * S
    ok = (t.data_ptr() % 16 == 0 and sh % 8 == 0 and ss % 8 == 0 and sb % 8 == 0
          and d <= sh <= ss <= sb)
    return (sb, ss, sh) if ok else None


def _tma_operand(t: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """``t`` and its strides when TMA can read it in place; otherwise an
    explicit copy into rows padded to 8 elements (16 bytes), which it can.
    The copy costs one read and one write of ``t``; the LM's projections
    never need it."""
    strides = _tma_strides(t)
    if strides is not None:
        return t, strides
    d = t.shape[-1]
    padded = torch.empty((*t.shape[:3], -(-d // 8) * 8), dtype=t.dtype, device=t.device)
    copy = padded[..., :d]
    copy.copy_(t)
    return copy, _tma_strides(copy)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    softmax_scale: float | None = None) -> torch.Tensor:
    """q (B, S, Hq, dh), k (B, S, Hkv, dh), v (B, S, Hkv, dhv) -> (B, S, Hq,
    dhv) in q's dtype; query head h reads KV head h // (Hq // Hkv). The
    scale is ``dh ** -0.5`` unless given; ``window`` keeps keys with
    ``q_pos - k_pos < window``. fp32 or bf16, dh and dhv <= 256, each
    tensor's last dimension contiguous. bf16 operands that TMA cannot read
    in place (a base not 16-byte aligned, a stride not a multiple of 8
    elements, strides out of (h, s, b) order) are copied first, see
    ``_tma_operand``."""
    _check_operands(q, k, v, window)
    B, S, Hq, dh = q.shape
    Hkv, dhv = k.shape[2], v.shape[3]
    # grid y: heads for the fp32 kernel, query tiles for the bf16 one
    rows = _WGMMA_ROWS if dhv <= 128 else _WGMMA_ROWS // 2
    grid_y = B * Hq if q.dtype == torch.float32 else -(-S // rows)
    if grid_y > _GRID_Y_MAX or B * Hq >= 2**31 or S >= 2**31:
        raise ValueError(f"shape exceeds the launch grid: B*Hq={B * Hq}, S={S}")
    scale = softmax_scale if softmax_scale is not None else dh ** -0.5
    out = torch.empty((B, S, Hq, dhv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if q.dtype == torch.bfloat16:
        (q, qs), (k, ks), (v, vs) = map(_tma_operand, (q, k, v))
    else:
        qs, ks, vs = q.stride()[:3], k.stride()[:3], v.stride()[:3]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                          _DTYPES[q.dtype], B, S, Hq, Hkv, dh, dhv, *qs, *ks, *vs,
                          float(scale), int(causal), 0 if window is None else int(window),
                          stream)
    _build.check(status, "flash_attention_fwd")
    LAUNCHES["flash_attention"] += 1
    return out


def _check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window,
                    extra: tuple = ()) -> None:
    """The checks both directions share: CUDA tensors on one device in one
    dtype (fp32 or bf16), (B, S, H, d) with the last dimension contiguous,
    GQA head counts, head dims 1..MAX_HEAD_DIM, a window >= 1 or None."""
    for name, t in (("q", q), ("k", k), ("v", v), *extra):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, got {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"q, k and v must share a dtype, got {q.dtype} and "
                             f"{t.dtype} ({name})")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, S, H, d), got {tuple(t.shape)}")
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    if q.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {q.dtype}; fp32 or bf16")
    B, S, Hq, dh = q.shape
    Hkv, dhv = k.shape[2], v.shape[3]
    if (k.shape[:2] != (B, S) or v.shape[:3] != (B, S, Hkv) or k.shape[3] != dh
            or Hkv < 1 or Hq % Hkv):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} (Hq must be a multiple of Hkv)")
    if not (1 <= dh <= MAX_HEAD_DIM and 1 <= dhv <= MAX_HEAD_DIM):
        raise ValueError(f"head dims dh={dh}, dhv={dhv}: the kernel takes 1..{MAX_HEAD_DIM}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, causal: bool = True,
                        window: int | None = None,
                        softmax_scale: float | None = None):
    """The gradient of :func:`flash_attention`: q, k, v as there, ``out``
    the forward's output and ``dout`` its cotangent (B, S, Hq, dhv) -> (dq,
    dk, dv), contiguous, in the inputs' shapes and dtype. Two kernels of
    ``csrc/flash_attention_bwd.cu`` on the current stream: the dq kernel
    (which also writes each row's log-sum-exp and rowsum(dout * out) into
    fp32 scratch) then the dk / dv kernel. Deterministic: no atomics."""
    B, S, Hq, dh = q.shape
    dhv = v.shape[3]
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    for name, t in (("out", out), ("dout", dout)):
        if tuple(t.shape) != (B, S, Hq, dhv):
            raise ValueError(f"{name} must be {(B, S, Hq, dhv)}, got {tuple(t.shape)}")
    _check_operands(q, k, v, window, (("out", out), ("dout", dout)))
    Hkv = k.shape[2]
    if B * Hq > _GRID_Y_MAX or S >= 2**31:
        raise ValueError(f"shape exceeds the launch grid: B*Hq={B * Hq}, S={S}")
    scale = softmax_scale if softmax_scale is not None else dh ** -0.5
    dq = torch.empty((B, S, Hq, dh), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, S, Hkv, dh), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, S, Hkv, dhv), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    stats = torch.empty((2, B * Hq, S), dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v, out, dout) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = _bwd_entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                              dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                              stats[0].data_ptr(), stats[1].data_ptr(), _DTYPES[q.dtype],
                              B, S, Hq, Hkv, dh, dhv, *strides, float(scale), int(causal),
                              0 if window is None else int(window), stream)
    _build.check(status, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
