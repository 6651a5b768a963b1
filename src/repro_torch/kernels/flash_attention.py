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

With ``return_lse`` the bf16 kernel also writes each row's log-sum-exp
(fp32, (B, Hq, S), in the log2 unit of its ``ex2`` softmax: log2 of the sum
of exp2(score * scale * log2(e)) over the row's visible keys), which the
backward reads instead of recomputing it; without it the kernel stores
nothing more.

``flash_attention_bwd`` is the gradient of the same function, from
``csrc/flash_attention_bwd.cu`` (no Pallas counterpart: the reference
trains through plain attention and lets autodiff take its gradient). bf16
runs on the tensor cores from the forward's ``lse``: a preprocess kernel
(rowsum(dout * out), the lse padded), a dq kernel (3 ``wgmma`` products a
key tile) and a dk / dv kernel (4 a query step, its two warpgroups owning
dV and dK). fp32 runs ``flash_attention_bwd_fma``, the first backward's
pair of kernels, fp32 FMA on the CUDA cores (it recomputes the log-sum-exp,
so it needs no saved one), which phase 2 of ``chip_smoke.py`` also times
at bf16 as the tensor-core route's yardstick. No route is atomic: each
output element is summed by one block in a fixed order, so two calls give
the same bits. ``kernels.ops.flash_attention`` is the autograd Function
over the two directions.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_Y_MAX = 65535
_WGMMA_ROWS = 128   # query rows per block of the bf16 kernel (64 where dhv > 128)
_STAT_PAD = 128     # the tensor-core backward pads its lse / D rows to this

LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}

_fn = None
_bwd_fn = None
# the tensor-core backward's C entry points: P and dS split into bf16 hi + lo
# (True, flash_attention_bwd.cu) or rounded to bf16 alone (False, the
# yardstick in flash_attention_bwd_unsplit.cu)
_bwd_tc_fns: dict[bool, object] = {}


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
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


def _bwd_tc_entry(split: bool):
    fn = _bwd_tc_fns.get(split)
    if fn is None:
        fn = (_build.load("flash_attention_bwd").flash_attention_bwd_wgmma if split else
              _build.load("flash_attention_bwd_unsplit").flash_attention_bwd_wgmma_unsplit)
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                       + [ctypes.c_int64] * 15
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_tc_fns[split] = fn
    return fn


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
                    softmax_scale: float | None = None, return_lse: bool = False):
    """q (B, S, Hq, dh), k (B, S, Hkv, dh), v (B, S, Hkv, dhv) -> (B, S, Hq,
    dhv) in q's dtype; query head h reads KV head h // (Hq // Hkv). The
    scale is ``dh ** -0.5`` unless given; ``window`` keeps keys with
    ``q_pos - k_pos < window``. fp32 or bf16, dh and dhv <= 256, each
    tensor's last dimension contiguous. bf16 operands that TMA cannot read
    in place (a base not 16-byte aligned, a stride not a multiple of 8
    elements, strides out of (h, s, b) order) are copied first, see
    ``_tma_operand``. With ``return_lse`` (bf16 only) -> (out, lse), lse
    fp32 (B, Hq, S) in the log2 unit (module docstring)."""
    _check_operands(q, k, v, window)
    if return_lse and q.dtype != torch.bfloat16:
        raise ValueError("return_lse: only the bf16 kernel writes the log-sum-exp "
                         "(the fp32 backward recomputes it)")
    B, S, Hq, dh = q.shape
    Hkv, dhv = k.shape[2], v.shape[3]
    # grid y: heads for the fp32 kernel, query tiles for the bf16 one
    rows = _WGMMA_ROWS if dhv <= 128 else _WGMMA_ROWS // 2
    grid_y = B * Hq if q.dtype == torch.float32 else -(-S // rows)
    if grid_y > _GRID_Y_MAX or B * Hq >= 2**31 or S >= 2**31:
        raise ValueError(f"shape exceeds the launch grid: B*Hq={B * Hq}, S={S}")
    scale = softmax_scale if softmax_scale is not None else dh ** -0.5
    out = torch.empty((B, S, Hq, dhv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    if q.dtype == torch.bfloat16:
        (q, qs), (k, ks), (v, vs) = map(_tma_operand, (q, k, v))
    else:
        qs, ks, vs = q.stride()[:3], k.stride()[:3], v.stride()[:3]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                          None if lse is None else lse.data_ptr(), _DTYPES[q.dtype], B, S,
                          Hq, Hkv, dh, dhv, *qs, *ks, *vs, float(scale), int(causal),
                          0 if window is None else int(window), stream)
    _build.check(status, "flash_attention_fwd")
    LAUNCHES["flash_attention"] += 1
    return (out, lse) if return_lse else out


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


def check_lse(lse, q: torch.Tensor) -> None:
    """Raise unless ``lse`` is what the forward saves for ``q`` (B, S, Hq,
    dh): fp32 (B, Hq, S) contiguous on q's device. Host-side, before any
    launch."""
    B, S, Hq = q.shape[:3]
    if not isinstance(lse, torch.Tensor):
        raise ValueError(f"lse must be the forward's fp32 (B, Hq, S) tensor, got "
                         f"{type(lse).__name__}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, Hq, S):
        raise ValueError(f"lse must be fp32 {(B, Hq, S)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous on {q.device}, got {lse.device}")


def _bwd_shapes(q, k, v, out, dout, window):
    B, S, Hq, dh = q.shape
    dhv = v.shape[3]
    for name, t in (("out", out), ("dout", dout)):
        if tuple(t.shape) != (B, S, Hq, dhv):
            raise ValueError(f"{name} must be {(B, S, Hq, dhv)}, got {tuple(t.shape)}")
    _check_operands(q, k, v, window, (("out", out), ("dout", dout)))


def _bwd_outputs(q, k, v):
    B, S, Hq, dh = q.shape
    Hkv, dhv = k.shape[2], v.shape[3]
    return (torch.empty((B, S, Hq, dh), dtype=q.dtype, device=q.device),
            torch.empty((B, S, Hkv, dh), dtype=q.dtype, device=q.device),
            torch.empty((B, S, Hkv, dhv), dtype=q.dtype, device=q.device))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, causal: bool = True,
                        window: int | None = None, softmax_scale: float | None = None,
                        lse: torch.Tensor | None = None):
    """The gradient of :func:`flash_attention`: q, k, v as there, ``out``
    the forward's output and ``dout`` its cotangent (B, S, Hq, dhv) -> (dq,
    dk, dv), contiguous, in the inputs' shapes and dtype. bf16 needs the
    forward's ``lse`` (``flash_attention(..., return_lse=True)``) and runs
    the tensor-core route: three kernels on the current stream (rowsum(dout
    * out) and the padded lse into fp32 scratch, then the dq kernel, then
    the dk / dv kernel). fp32 runs :func:`flash_attention_bwd_fma`, which
    recomputes the log-sum-exp: a given ``lse`` is checked and not read.
    Deterministic: no atomics."""
    if lse is not None or q.dtype == torch.bfloat16:
        check_lse(lse, q)
    if q.dtype != torch.bfloat16:
        return flash_attention_bwd_fma(q, k, v, out, dout, causal, window, softmax_scale)
    return _bwd_wgmma(q, k, v, out, dout, causal, window, softmax_scale, lse, split=True)


def flash_attention_bwd_unsplit(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                out: torch.Tensor, dout: torch.Tensor, causal: bool = True,
                                window: int | None = None,
                                softmax_scale: float | None = None,
                                lse: torch.Tensor | None = None):
    """The tensor-core route with P and dS rounded to bf16 alone as the A
    operands of dV += P^T dO, dK += dS^T Q and dQ += dS K, where
    :func:`flash_attention_bwd` splits each into bf16 hi + lo (twice those
    products' tensor work). Its results leave BWD_TOL (``chip_smoke.py``);
    phase 2 times it to show what the split costs. bf16 only."""
    check_lse(lse, q)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the tensor-core route takes bf16, got {q.dtype}")
    return _bwd_wgmma(q, k, v, out, dout, causal, window, softmax_scale, lse, split=False)


def _bwd_wgmma(q, k, v, out, dout, causal, window, softmax_scale, lse, split: bool):
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    _bwd_shapes(q, k, v, out, dout, window)
    B, S, Hq, dh = q.shape
    Hkv, dhv = k.shape[2], v.shape[3]
    # grid x: heads; y: 64-key (dk / dv) or 64 / 128-query (dq) tiles
    if B * Hq >= 2**31 or -(-S // 64) > _GRID_Y_MAX:
        raise ValueError(f"shape exceeds the launch grid: B*Hq={B * Hq}, S={S}")
    scale = softmax_scale if softmax_scale is not None else dh ** -0.5
    dq, dk, dv = _bwd_outputs(q, k, v)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    (q, qs), (k, ks), (v, vs), (dout, gs) = map(_tma_operand, (q, k, v, dout))
    s_pad = -(-S // _STAT_PAD) * _STAT_PAD
    scratch = torch.empty((2, B * Hq, s_pad), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = _bwd_tc_entry(split)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
            B, S, Hq, Hkv, dh, dhv, *qs, *ks, *vs, *out.stride()[:3], *gs, float(scale),
            int(causal), 0 if window is None else int(window), stream)
    _build.check(status, "flash_attention_bwd_wgmma")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


def flash_attention_bwd_fma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, dout: torch.Tensor, causal: bool = True,
                            window: int | None = None,
                            softmax_scale: float | None = None):
    """The first backward, fp32 FMA on the CUDA cores, fp32 or bf16: two
    kernels of ``csrc/flash_attention_bwd.cu`` on the current stream, the dq
    kernel (which also writes each row's log-sum-exp and rowsum(dout * out)
    into fp32 scratch) then the dk / dv kernel. The fp32 route of
    :func:`flash_attention_bwd`, and the tensor-core route's yardstick."""
    B, S, Hq, dh = q.shape
    dhv = v.shape[3]
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    _bwd_shapes(q, k, v, out, dout, window)
    Hkv = k.shape[2]
    if B * Hq > _GRID_Y_MAX or S >= 2**31:
        raise ValueError(f"shape exceeds the launch grid: B*Hq={B * Hq}, S={S}")
    scale = softmax_scale if softmax_scale is not None else dh ** -0.5
    dq, dk, dv = _bwd_outputs(q, k, v)
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
