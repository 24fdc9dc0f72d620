"""Flash-attention forward (K1): the hand-written CUDA kernel and its plain
PyTorch version.

The kernel (csrc/flash_attention.cu) replaces the JAX package's Pallas TPU
kernel `_flash_kernel` (consistentid_tpu/ops/flash_attention.py). The source
file's header states what bounds it on an H100 and how its design answers.

`flash_attention` takes (B, H, S, D) tensors. A CUDA tensor launches the
kernel or raises; a CPU tensor takes `flash_attention_plain`, the same
function in plain torch, which is also what the kernel is held against on
the card. Each launch adds one to `flash_attention.launches`.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .build import load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_HEAD_DIM = 128
PLAIN_BLOCK_Q = 1024


def _kernel():
    lib = load_library("flash_attention", ["flash_attention.cu"])
    fn = lib.cid_flash_attention_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
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
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one of "
                        "float32, bfloat16, float16")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k, v")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          sm_scale: Optional[float] = None) -> torch.Tensor:
    """K1's function in plain torch: fp32 scores and softmax over all keys,
    taken PLAIN_BLOCK_Q query rows at a time to bound the score memory;
    output in q's dtype."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    kf = k.float().transpose(-1, -2)
    vf = v.float()
    out = []
    for start in range(0, q.shape[2], PLAIN_BLOCK_Q):
        qb = q[:, :, start:start + PLAIN_BLOCK_Q].float()
        p = torch.softmax(torch.matmul(qb, kf) * sm_scale, dim=-1)
        out.append(torch.matmul(p, vf))
    return torch.cat(out, dim=2).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Non-causal multi-head attention, (B, H, Sq, D) x (B, H, Sk, D)."""
    _check(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    fn = _kernel()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b * h, sq, sk, d, float(sm_scale), _DTYPE_CODES[q.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
