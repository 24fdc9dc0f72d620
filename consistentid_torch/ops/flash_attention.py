"""Flash attention: the hand-written CUDA kernels K1-K4, their plain PyTorch
versions, and the autograd Function that joins them.

The kernels replace the JAX package's Pallas TPU kernels
(consistentid_tpu/ops/flash_attention.py):
  K1 `flash_attention_fwd`  <- `_flash_kernel`          (..._sm90.cu,
                                                          flash_attention.cu)
  K2 `flash_attention_lse`  <- `_flash_fwd_lse_kernel`  (..._sm90.cu,
                                                          flash_attention.cu)
  K3 + K4 `flash_attention_bwd`
                            <- `_flash_bwd_dq_kernel` and
                               `_flash_bwd_dkv_kernel`  (..._bwd_sm90.cu,
                                                          ..._bwd.cu)
with the sources in csrc/.
The source files' headers state what bounds each on an H100 and how its
design answers.

Each wrapper has three kernels, chosen by `forward_route` (K1, K2) or
`backward_route` (K3 + K4) from the call's dtype, head dim, alignment and
scale, never by failure: "sm90" (wgmma fed by TMA) for bf16/fp16 with
head_dim a multiple of 8 up to 128, 16-byte aligned tensors and a positive
scale, which is every shape the models produce; "mma" (mma.sync) for any
other 16-bit call; "f32" (SIMT) for fp32. The sm90 forward is
flash_attention_sm90.cu; the sm90 backward, flash_attention_bwd_sm90.cu, is
one fused kernel that computes dq, dk and dv together (dq through a
workspace that its key blocks add into as fixed-point integers, exact in
any order, so dq, like dk and dv, is the same bits on every run).
The mma and f32 routes run flash_attention.cu (K1, K2) and the two kernels
of flash_attention_bwd.cu (dq; dk and dv).

Every wrapper takes (B, H, S, D) tensors (lse and delta (B, H, Sq) fp32). A
CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version (`flash_attention_plain`, `flash_attention_lse_plain`,
`flash_attention_bwd_plain`), which is also what each kernel is held against
on the card. Each call that launches adds one to the wrapper's `.launches`
and to its route's count in `.launches_by_route`.

`flash_attention` is the entry point, the counterpart of the JAX package's
differentiable `flash_attention` (custom VJP `_flash_diff`): when autograd
needs its gradient it runs `FlashAttentionFunction` (K2 forward, K3 + K4
backward); otherwise it runs K1. The same holds on the CPU with the plain
versions, so the gradient does not depend on the device.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .build import load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_HEAD_DIM = 128
PLAIN_BLOCK_Q = 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_FWD_ARGS = [_P] * 4 + [_I] * 4 + [ctypes.c_float, _I, _P]
_LSE_ARGS = [_P] * 5 + [_I] * 4 + [ctypes.c_float, _I, _P]
_SIGNATURES = {
    # symbol: (library, argtypes)
    "cid_flash_attention_forward": ("flash_attention", _FWD_ARGS),
    "cid_flash_attention_forward_lse": ("flash_attention", _LSE_ARGS),
    "cid_flash_attention_forward_sm90": ("flash_attention_sm90", _FWD_ARGS),
    "cid_flash_attention_forward_lse_sm90":
        ("flash_attention_sm90", _LSE_ARGS),
    "cid_flash_attention_backward_dq":
        ("flash_attention_bwd",
         [_P] * 7 + [_I] * 4 + [ctypes.c_float, _I, _P]),
    "cid_flash_attention_backward_dkv":
        ("flash_attention_bwd",
         [_P] * 8 + [_I] * 4 + [ctypes.c_float, _I, _P]),
    "cid_flash_attention_backward_sm90":
        ("flash_attention_bwd_sm90",
         [_P] * 10 + [_I] * 4 + [ctypes.c_float, _I, _P]),
}


def _kernel(symbol: str):
    lib_name, argtypes = _SIGNATURES[symbol]
    fn = getattr(load_library(lib_name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _launch(symbol: str, device: torch.device, *args) -> None:
    """Call a kernel's C entry point on the current stream of `device`:
    tensors pass as their data pointers; raises on a launch error."""
    fn = _kernel(symbol)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*ptrs, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           allow_double: bool = False) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes (B, H, S, D) tensors")
    if k.shape != v.shape or q.shape[:2] != k.shape[:2] or \
            q.shape[3] != k.shape[3]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not 1 <= q.shape[3] <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {q.shape[3]} outside 1..{MAX_HEAD_DIM}")
    if q.shape[2] < 1 or k.shape[2] < 1:
        raise ValueError("empty sequence")
    dtypes = set(_DTYPE_CODES)
    if allow_double and q.device.type == "cpu":
        dtypes.add(torch.float64)   # plain version only (gradcheck)
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in dtypes:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one of "
                        "float32, bfloat16, float16")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k, v")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")


def _check_bwd(q, k, v, do, lse, delta) -> None:
    _check(q, k, v, allow_double=True)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} does not match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if not do.is_contiguous():
        raise ValueError("flash attention backward needs a contiguous dO")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:3] or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} must be (B, H, Sq) = "
                             f"{tuple(q.shape[:3])} on {q.device}")
        if t.dtype != torch.float32 and not (
                q.dtype == torch.float64 and t.dtype == torch.float64):
            raise TypeError(f"{name} must be float32, not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


def _stat_dtype(q: torch.Tensor) -> torch.dtype:
    return torch.float64 if q.dtype == torch.float64 else torch.float32


# ---------------------------------------------------------------- routes

ROUTES = ("sm90", "mma", "f32")
# K1/K2's C entry point per route: (forward, forward with lse)
_ROUTE_SYMBOLS = {
    "sm90": ("cid_flash_attention_forward_sm90",
             "cid_flash_attention_forward_lse_sm90"),
    "mma": ("cid_flash_attention_forward", "cid_flash_attention_forward_lse"),
    "f32": ("cid_flash_attention_forward", "cid_flash_attention_forward_lse"),
}


def forward_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  sm_scale: Optional[float] = None) -> str:
    """The kernel a CUDA call of K1 or K2 launches: "sm90" when TMA can load
    the tensors (bf16 or fp16, head_dim a multiple of 8 up to 128, every base
    pointer 16-byte aligned) and the scale is positive (the kernel folds it
    into the running max); "mma" for any other 16-bit call; "f32" for fp32."""
    if q.dtype not in (torch.bfloat16, torch.float16):
        return "f32"
    d = q.shape[-1]
    if (d % 8 == 0 and d <= MAX_HEAD_DIM and _scale(q, sm_scale) > 0
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v))):
        return "sm90"
    return "mma"


def backward_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   do: torch.Tensor, sm_scale: Optional[float] = None) -> str:
    """The kernels a CUDA call of K3 + K4 launches: "sm90" (the fused
    kernel) under forward_route's conditions with dO aligned too; "mma"
    (K3's and K4's mma.sync kernels) for any other 16-bit call; "f32" (their
    SIMT kernels) for fp32."""
    route = forward_route(q, k, v, sm_scale)
    if route == "sm90" and do.data_ptr() % 16 != 0:
        return "mma"
    return route


def sm90_padded_depth(head_dim: int) -> int:
    """The depth the sm90 kernels pad head_dim to in shared memory (their
    template instantiations, flash_attention_sm90.cu and
    flash_attention_bwd_sm90.cu): 40 -> 48, 64, 80 and 128 as they are, any
    other multiple of 8 to the first that holds it."""
    if head_dim % 8 != 0 or not 8 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"the sm90 kernel takes no head_dim {head_dim}")
    return next(dp for dp in (48, 64, 80, 128) if head_dim <= dp)


def _count(wrapper, route: str) -> None:
    wrapper.launches += 1
    wrapper.launches_by_route[route] += 1


def sm90_bwd_workspace_floats(bh: int, sq: int, head_dim: int) -> int:
    """The workspace (in fp32 words) the sm90 backward adds dq into, beside
    its staged statistics: per (b*h, 64-row q tile), 64 x padded depth
    64-bit fixed-point partial sums and 128 statistics (lse, delta); per
    head, 32 blocks' maxima of dO, K and V and the fixed-point scale
    (flash_attention_bwd_sm90.cu)."""
    q_tiles = -(-sq // 64)
    return bh * q_tiles * (128 * sm90_padded_depth(head_dim) + 128) + 97 * bh


def reset_launches(*wrappers) -> None:
    """Set the launch counts of the given wrappers (default K1, K2 and
    K3 + K4) to 0, their split by route too."""
    for w in wrappers or (flash_attention_fwd, flash_attention_lse,
                          flash_attention_bwd):
        w.launches = 0
        if hasattr(w, "launches_by_route"):
            w.launches_by_route = dict.fromkeys(ROUTES, 0)


# ------------------------------------------------------------ plain versions

def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          sm_scale: Optional[float] = None) -> torch.Tensor:
    """K1's function in plain torch: fp32 scores and softmax over all keys,
    taken PLAIN_BLOCK_Q query rows at a time to bound the score memory;
    output in q's dtype."""
    sm_scale = _scale(q, sm_scale)
    kf = k.float().transpose(-1, -2)
    vf = v.float()
    out = []
    for start in range(0, q.shape[2], PLAIN_BLOCK_Q):
        qb = q[:, :, start:start + PLAIN_BLOCK_Q].float()
        p = torch.softmax(torch.matmul(qb, kf) * sm_scale, dim=-1)
        out.append(torch.matmul(p, vf))
    return torch.cat(out, dim=2).to(q.dtype)


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              sm_scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's function in plain torch: K1's output and the per-row logsumexp
    of the scaled scores, lse = m + log(l), fp32 (B, H, Sq)."""
    sm_scale = _scale(q, sm_scale)
    acc = _stat_dtype(q)
    kf = k.to(acc).transpose(-1, -2)
    vf = v.to(acc)
    outs, lses = [], []
    for start in range(0, q.shape[2], PLAIN_BLOCK_Q):
        s = torch.matmul(q[:, :, start:start + PLAIN_BLOCK_Q].to(acc),
                         kf) * sm_scale
        lse = torch.logsumexp(s, dim=-1)
        outs.append(torch.matmul(torch.exp(s - lse[..., None]), vf))
        lses.append(lse)
    return torch.cat(outs, dim=2).to(q.dtype), torch.cat(lses, dim=2)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, do: torch.Tensor,
                              lse: torch.Tensor, delta: torch.Tensor,
                              sm_scale: Optional[float] = None,
                              round_to: Optional[torch.dtype] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """K3's and K4's function in plain torch, in fp32 as the JAX package's
    `_flash_backward` returns it: with P = exp(s Q K^T - lse),
    dP = dO V^T and dS = P o (dP - delta),
    dq = s dS K, dk = s dS^T Q, dv = P^T dO.
    With `round_to` (bfloat16 or float16), P and dS are rounded to it before
    their products, as the tensor-core kernels round them: the control at
    the kernels' own precision that the card checks hold K3 and K4 to."""
    sm_scale = _scale(q, sm_scale)
    acc = _stat_dtype(q)

    def operand(t):
        return t if round_to is None else t.to(round_to).to(acc)
    kf, vf = k.to(acc), v.to(acc)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    dqs = []
    for start in range(0, q.shape[2], PLAIN_BLOCK_Q):
        rows = slice(start, start + PLAIN_BLOCK_Q)
        qb = q[:, :, rows].to(acc)
        dob = do[:, :, rows].to(acc)
        p = torch.exp(torch.matmul(qb, kf.transpose(-1, -2)) * sm_scale
                      - lse[:, :, rows, None].to(acc))
        dp = torch.matmul(dob, vf.transpose(-1, -2))
        ds = operand(p * (dp - delta[:, :, rows, None].to(acc)))
        dqs.append(torch.matmul(ds, kf) * sm_scale)
        dk += torch.matmul(ds.transpose(-1, -2), qb)
        dv += torch.matmul(operand(p).transpose(-1, -2), dob)
    return torch.cat(dqs, dim=2), dk * sm_scale, dv


# ------------------------------------------------------------------ wrappers

def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """K1: the forward, output in q's dtype."""
    _check(q, k, v)
    sm_scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, sm_scale)
    b, h, sq, d = q.shape
    route = forward_route(q, k, v, sm_scale)
    out = torch.empty_like(q)
    _launch(_ROUTE_SYMBOLS[route][0], q.device, q, k, v, out, b * h, sq,
            k.shape[2], d, float(sm_scale), _DTYPE_CODES[q.dtype])
    _count(flash_attention_fwd, route)
    return out


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: the forward and its per-row logsumexp (B, H, Sq) fp32."""
    _check(q, k, v, allow_double=True)
    sm_scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_lse_plain(q, k, v, sm_scale)
    b, h, sq, d = q.shape
    route = forward_route(q, k, v, sm_scale)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _launch(_ROUTE_SYMBOLS[route][1], q.device, q, k, v, out, lse,
            b * h, sq, k.shape[2], d, float(sm_scale), _DTYPE_CODES[q.dtype])
    _count(flash_attention_lse, route)
    return out, lse


def flash_attention_bwd(q, k, v, do, lse, delta,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 + K4: dq, dk and dv in the inputs' dtype, from the forward's lse
    and delta = rowsum(dO o O). On the card, by `backward_route`: the fused
    sm90 kernel, or K3's and K4's mma.sync or SIMT kernels."""
    _check_bwd(q, k, v, do, lse, delta)
    sm_scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        dq, dk, dv = flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                               sm_scale)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    route = backward_route(q, k, v, do, sm_scale)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    args = (b * h, sq, sk, d, float(sm_scale), _DTYPE_CODES[q.dtype])
    if route == "sm90":
        workspace = torch.empty(sm90_bwd_workspace_floats(b * h, sq, d),
                                dtype=torch.float32, device=q.device)
        _launch("cid_flash_attention_backward_sm90", q.device, q, k, v, do,
                lse, delta, dq, dk, dv, workspace, *args)
    else:
        _launch("cid_flash_attention_backward_dq", q.device, q, k, v, do,
                lse, delta, dq, *args)
        _launch("cid_flash_attention_backward_dkv", q.device, q, k, v, do,
                lse, delta, dk, dv, *args)
    _count(flash_attention_bwd, route)
    return dq, dk, dv


flash_attention_fwd.launches_by_route = {}
flash_attention_lse.launches_by_route = {}
flash_attention_bwd.launches_by_route = {}
reset_launches()


# ------------------------------------------------------------------ autograd

class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention (JAX `_flash_diff`): the forward keeps
    q, k, v, o and the logsumexp; the backward takes
    delta = rowsum(dO o O) in fp32 (plain torch, as JAX computes it outside
    any kernel), then dq, dk and dv from K3 + K4, in the inputs' dtype."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        out, lse = flash_attention_lse(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        acc = _stat_dtype(q)
        delta = (do.to(acc) * out.to(acc)).sum(dim=-1)
        dq, dk, dv = flash_attention_bwd(q, k, v, do, lse, delta,
                                         ctx.sm_scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Non-causal multi-head attention, (B, H, Sq, D) x (B, H, Sk, D): K1
    when no gradient is needed, FlashAttentionFunction (K2; K3 + K4) when
    autograd records. The launches are counted on the kernels' wrappers:
    `flash_attention_fwd.launches` (K1), `flash_attention_lse.launches`
    (K2) and `flash_attention_bwd.launches` (K3 + K4)."""
    _check(q, k, v)
    sm_scale = _scale(q, sm_scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, sm_scale)
    return flash_attention_fwd(q, k, v, sm_scale)
