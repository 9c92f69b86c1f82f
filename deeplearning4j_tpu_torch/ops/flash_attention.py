"""Flash attention: hand-written Hopper kernels and their plain PyTorch
versions, forward and backward.

Counterpart of the JAX package's `ops/flash_attention.py`. Semantics are
the reference's (tested against it):

- (B, T, H, D) layout, f32 accumulation, 1/sqrt(D) scaling;
- optional causal masking (absolute positions, as in the reference);
- optional (B, Tk) 0/1 key-validity mask; fully-masked query rows give 0;
- `return_lse` adds the per-row log-sum-exp (B, T, H); fully-masked rows
  carry the kernel's +1e30 sentinel internally and -1e30 at the public
  boundary, so the LSE merge rule gives them zero weight;
- the gradient is the reference's flash backward (`_flash`'s custom_vjp):
  p is recomputed from the saved LSE, the LSE's own cotangent folds into
  the row term delta, and the mask gets no gradient.

Dispatch: a CPU tensor goes to the plain versions (`flash_attention_plain`,
`flash_attention_bwd_plain`). A CUDA tensor always launches the kernels:
`csrc/flash_attention_fwd.cu` forward, `csrc/flash_attention_bwd.cu`
(dQ, then dK/dV) backward. Whatever goes wrong (the build, a refused
launch, a dtype or head dim the kernels do not take) raises; there is no
fallback. `KERNEL_LAUNCHES` counts the launches by kernel.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.util.env import env_int

NEG = -1e30

#: kernel launches by kernel name; each wrapper adds one where it launches
KERNEL_LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
_COUNT_LOCK = threading.Lock()

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (32, 64, 128)


def _masked_scores(q, k, mask, causal: bool, acc_t):
    """Scaled scores (B, H, Tq, Tk) with the key mask and the causal rule
    applied as NEG: the one copy of the masking the plain versions share
    (the reference's `_masked_scores`)."""
    tq, tk, d = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc_t), k.to(acc_t)) \
        * (1.0 / math.sqrt(d))
    if mask is not None:
        s = torch.where(mask[:, None, None, :] > 0, s,
                        torch.full_like(s, NEG))
    if causal:
        qpos = torch.arange(tq, device=q.device)[:, None]
        kpos = torch.arange(tk, device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, torch.full_like(s, NEG))
    return s


def flash_attention_plain(q, k, v, mask=None, causal: bool = False):
    """Dense attention with the kernel's semantics: (out, lse).

    q (B, Tq, H, D), k and v (B, Tk, H, D), mask (B, Tk) or None. Scores
    and sums are in f32 (f64 for f64 inputs). Returns out (B, Tq, H, D) in
    q's dtype and lse (B*H, Tq) with +1e30 on fully-masked rows."""
    b, tq, h, d = q.shape
    acc_t = torch.promote_types(torch.float32, q.dtype)
    s = _masked_scores(q, k, mask, causal, acc_t)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > NEG / 2, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    dead = m <= NEG / 2
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(acc_t)) \
        / l.permute(0, 2, 1, 3)
    out = torch.where(dead.permute(0, 2, 1, 3), torch.zeros_like(out), out)
    lse = torch.where(dead, torch.full_like(m, -NEG), m + torch.log(l))
    return out.to(q.dtype), lse.reshape(b * h, tq)


def _delta(out, g_out, g_lse, acc_t):
    """The backward's row term (B*H, Tq): rowsum(dO * O) - g_lse. The LSE
    output is differentiable too (d lse_i / d s_ij = p_ij), so its
    cotangent folds in here and the kernels need no change."""
    b, tq, h, _ = out.shape
    delta = (g_out.to(acc_t) * out.to(acc_t)).sum(-1)         # (B, Tq, H)
    return (delta.permute(0, 2, 1).reshape(b * h, tq)
            - g_lse.to(acc_t)).contiguous()


def flash_attention_bwd_plain(q, k, v, mask, out, lse, g_out, g_lse,
                              causal: bool = False):
    """The gradient (dq, dk, dv) by the kernels' own algorithm, dense.

    `out` and `lse` (B*H, Tq) are the forward's; `g_out` and `g_lse` the
    cotangents of out and of the internal LSE. p = exp(s - lse) is
    recomputed and zeroed where s <= NEG/2, dp = dO V^T,
    ds = p * (dp - delta), dQ = scale ds K, dK = scale ds^T Q, dV = p^T dO.
    In f32, or f64 for f64 inputs; results in the inputs' dtypes."""
    b, tq, h, d = q.shape
    acc_t = torch.promote_types(torch.float32, q.dtype)
    scale = 1.0 / math.sqrt(d)
    s = _masked_scores(q, k, mask, causal, acc_t)
    lse4 = lse.to(acc_t).reshape(b, h, tq, 1)
    p = torch.where(s > NEG / 2, torch.exp(s - lse4), torch.zeros_like(s))
    delta = _delta(out, g_out, g_lse, acc_t).reshape(b, h, tq, 1)
    qf, kf, vf, gf = (t.to(acc_t) for t in (q, k, v, g_out))
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", gf, vf) - delta)
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """The kernels read 16 bytes at a time along D: they need a unit D
    stride, 16-byte-aligned rows and base. Copy only when that fails."""
    vw = 16 // x.element_size()
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(s % vw == 0 for s in x.stride()[:-1]))
    return x if ok else x.clone(memory_format=torch.contiguous_format)


_POINTERS = {"dl4j_flash_attention_fwd": 6,
             "dl4j_flash_attention_bwd_dq": 8,
             "dl4j_flash_attention_bwd_dkv": 9}
_STRIDED = {"dl4j_flash_attention_fwd": 4,
            "dl4j_flash_attention_bwd_dq": 5,
            "dl4j_flash_attention_bwd_dkv": 6}


def _kernel_fn(source: str, symbol: str):
    """The C entry `symbol` of the library built from csrc/<source>.cu,
    with its ctypes signature: pointers, (B, H, Tq, Tk, D), three strides
    per strided operand, then dtype, causal, scale and the stream."""
    from deeplearning4j_tpu_torch.ops import _build
    lib = _build.load(source)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * _POINTERS[symbol]
                       + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * (3 * _STRIDED[symbol])
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.dl4j_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _check_kernel_inputs(q, k, v):
    """Raise on anything the kernels do not take."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash kernel needs q, k and v of one dtype")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dims {_KERNEL_HEAD_DIMS}, "
                         f"got {d}")
    if k.shape != (b, tk, h, d) or v.shape != (b, tk, h, d):
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError("q, k and v must be on one device")
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernels take CUDA tensors, got "
                         f"{q.device} (CPU tensors take the plain versions)")


def _kernel_mask(mask, b, tk, device):
    if mask is None:
        return None
    if tuple(mask.shape) != (b, tk):
        raise ValueError(f"mask shape {tuple(mask.shape)} != {(b, tk)}")
    return mask.to(device=device, dtype=torch.float32).contiguous()


def _launch(lib, fn, name, *args):
    """Call a C entry on the current stream; raise if the launch failed,
    count it if not."""
    err = fn(*args[:-1], torch.cuda.current_stream(args[-1]).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: cuda error {err} "
            f"({lib.dl4j_cuda_error_string(err).decode()})")
    with _COUNT_LOCK:
        KERNEL_LAUNCHES[name] += 1


def flash_attention_cuda(q, k, v, mask=None, causal: bool = False):
    """Launch the Hopper forward kernel: (out, lse) as
    `flash_attention_plain`. Raises on anything the kernel does not take.
    Its outputs carry no autograd history, so a call that should record
    one (grad mode on, an input requiring grad) raises: use
    `flash_attention`, whose backward is the kernels'."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_attention_cuda records no gradient; call "
            "flash_attention, whose backward launches the dQ and dK/dV "
            "kernels")
    _check_kernel_inputs(q, k, v)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    mask = _kernel_mask(mask, b, tk, q.device)
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, tq), dtype=torch.float32, device=q.device)
    lib, fn = _kernel_fn("flash_attention_fwd", "dl4j_flash_attention_fwd")
    with torch.cuda.device(q.device):
        _launch(lib, fn, "flash_fwd",
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if mask is None else mask.data_ptr(),
                out.data_ptr(), lse.data_ptr(), b, h, tq, tk, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *out.stride()[:3], _KERNEL_DTYPES[q.dtype], int(causal),
                1.0 / math.sqrt(d), q.device)
    return out, lse


def _bwd_args(q, k, v, mask, lse, delta, g_out):
    """Check the backward kernels' operands, raising on anything they do
    not take; returns the pointer, size and stride arguments both C
    entries share."""
    _check_kernel_inputs(q, k, v)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if g_out.shape != q.shape or g_out.dtype != q.dtype \
            or g_out.device != q.device:
        raise ValueError(f"g_out {tuple(g_out.shape)} {g_out.dtype} does not "
                         f"match q {tuple(q.shape)} {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("g_out", g_out)):
        if _aligned(t) is not t:
            raise ValueError(f"{name} needs a unit D stride and 16-byte "
                             "aligned rows (pass it through _aligned)")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (b * h, tq) or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"{(b * h, tq)} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if mask is not None and (tuple(mask.shape) != (b, tk)
                             or mask.dtype != torch.float32
                             or not mask.is_contiguous()
                             or mask.device != q.device):
        raise ValueError(f"mask must be a contiguous float32 {(b, tk)}")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g_out.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if mask is None else mask.data_ptr())
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *g_out.stride()[:3])
    return ptrs, (b, h, tq, tk, d), strides


def flash_attention_bwd_dq_cuda(q, k, v, mask, lse, delta, g_out,
                                causal: bool = False):
    """Launch the dQ kernel. q, k, v, g_out as the kernel reads them
    (`_aligned`), lse and delta contiguous (B*H, Tq) f32, mask a
    contiguous f32 (B, Tk) or None. Returns dq, contiguous."""
    ptrs, dims, strides = _bwd_args(q, k, v, mask, lse, delta, g_out)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib, fn = _kernel_fn("flash_attention_bwd", "dl4j_flash_attention_bwd_dq")
    with torch.cuda.device(q.device):
        _launch(lib, fn, "flash_bwd_dq", *ptrs, dq.data_ptr(), *dims,
                *strides, *dq.stride()[:3], _KERNEL_DTYPES[q.dtype],
                int(causal), 1.0 / math.sqrt(q.shape[-1]), q.device)
    return dq


def flash_attention_bwd_dkv_cuda(q, k, v, mask, lse, delta, g_out,
                                 causal: bool = False):
    """Launch the dK/dV kernel; arguments as `flash_attention_bwd_dq_cuda`.
    Returns (dk, dv), contiguous."""
    ptrs, dims, strides = _bwd_args(q, k, v, mask, lse, delta, g_out)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    lib, fn = _kernel_fn("flash_attention_bwd",
                         "dl4j_flash_attention_bwd_dkv")
    with torch.cuda.device(q.device):
        _launch(lib, fn, "flash_bwd_dkv", *ptrs, dk.data_ptr(),
                dv.data_ptr(), *dims, *strides, *dk.stride()[:3],
                *dv.stride()[:3], _KERNEL_DTYPES[q.dtype], int(causal),
                1.0 / math.sqrt(q.shape[-1]), q.device)
    return dk, dv


def flash_attention_bwd_cuda(q, k, v, mask, out, lse, g_out, g_lse,
                             causal: bool = False):
    """Launch the Hopper backward kernels, dQ then dK/dV: (dq, dk, dv) as
    `flash_attention_bwd_plain`. delta is computed here with torch ops in
    f32, as the reference computes it in XLA outside its kernels. The
    operands are checked by the two launchers."""
    delta = _delta(out, g_out, g_lse, torch.float32)
    q, k, v, g_out = (_aligned(t) for t in (q, k, v, g_out))
    mask = _kernel_mask(mask, q.shape[0], k.shape[1], q.device)
    lse = lse.contiguous()
    dq = flash_attention_bwd_dq_cuda(q, k, v, mask, lse, delta, g_out, causal)
    dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, mask, lse, delta, g_out,
                                          causal)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """(out, lse) with the flash backward: the counterpart of the
    reference's `_flash` custom_vjp. The mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal):
        run = flash_attention_cuda if q.is_cuda else flash_attention_plain
        out, lse = run(q, k, v, mask, causal)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.causal = causal
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, mask, out, lse = ctx.saved_tensors
        run = flash_attention_bwd_cuda if q.is_cuda \
            else flash_attention_bwd_plain
        dq, dk, dv = run(q, k, v, mask, out, lse, g_out, g_lse, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, mask=None, causal: bool = False,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    return_lse: bool = False):
    """Fused flash attention on (B, T, H, D); see the module docstring.
    Differentiable in q, k and v (and through the returned LSE).

    Sequence lengths are padded to the block size (padded keys are
    mask-excluded; padded query rows are sliced off, so autograd gives
    them a zero cotangent), as in the reference. The CUDA kernels tile by
    64 whatever the block size, so `block_q` and `block_k` only set the
    padding granularity here, which changes no result.
    DL4J_CUDA_FLASH_BLOCK_Q/K take precedence over the caller's sizes,
    like the reference's DL4J_TPU_ knobs."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    bq_env = env_int("DL4J_CUDA_FLASH_BLOCK_Q")
    bk_env = env_int("DL4J_CUDA_FLASH_BLOCK_K")
    block_q = bq_env if bq_env else (block_q or 128)
    block_k = bk_env if bk_env else (block_k or 128)
    block_q = min(block_q, max(tq, 1))
    block_k = min(block_k, max(tk, 1))
    pq = (-tq) % block_q
    pk = (-tk) % block_k
    if mask is None and pk:
        mask = torch.ones((b, tk), dtype=torch.float32, device=q.device)
    if pq or pk:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
        if mask is not None:
            mask = F.pad(mask, (0, pk))
    if mask is not None:
        mask = mask.detach()
    out, lse = _Flash.apply(q, k, v, mask, causal)
    if not return_lse:
        return out[:, :tq]
    lse = lse.reshape(b, h, -1).transpose(1, 2)[:, :tq]
    # kernel-internal fully-masked-row sentinel (+1e30) -> -1e30 at the
    # public boundary, so the merge rule gives those rows zero weight (and
    # passes no cotangent back to them)
    lse = torch.where(lse >= -NEG / 10, torch.full_like(lse, NEG), lse)
    return out[:, :tq], lse
