"""Fused BatchNorm + activation: the hand-written CUDA kernels K5 and K6,
their plain PyTorch versions, and the cross-process SyncBN variant.

The kernels replace the JAX package's Pallas TPU kernels
(consistentid_tpu/ops/fused_bn_act.py):
  K5 `batch_moments` <- `_moments_kernel`    (csrc/fused_bn_act.cu)
  K6 `apply_bn_act`  <- `_normalize_kernel`  (csrc/fused_bn_act.cu)
The source's header states what bounds them on an H100 (bytes) and how the
design answers.

Every function takes NHWC tensors (B, H, W, C), as the JAX package does, of
float32, bfloat16 or float16; statistics are fp32 (C,). A CUDA tensor
launches the kernel or raises; a CPU tensor takes the plain version
(`batch_moments_plain`, `apply_bn_act_plain`), which is also what each
kernel is held against on the card. Each launch adds one to the wrapper's
`.launches`.

`fused_bn_act` is K5 then K6 (train-mode BatchNorm + activation on one
device, the InPlaceABN equivalent); `sync_batch_norm_act` all-reduces the
moments over a `torch.distributed` group first. No model of the port calls
them, as no model of the JAX package does: its BiSeNet, ArcFace and SCRFD use
a plain BatchNorm.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .build import load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ACTIVATIONS = ("leaky_relu", "relu", "silu", "identity")
THREADS = 256             # CTA size of both kernels
H100_SMS = 132
MOMENT_CTAS_PER_SM = 4    # K5 pass 1 aims at this many CTAs per SM
MIN_CHUNK_ROWS = 256      # ... each summing at least this many rows

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    "cid_bn_moments": [_P] * 5 + [_L, _I, _I, _I, _L, _I, _I, _P],
    "cid_bn_apply": [_P] * 6 + [_L, _I, _I, _I, _I, _I, ctypes.c_float, _I,
                                _P],
}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _kernel(symbol: str):
    fn = getattr(load_library("fused_bn_act"), symbol)
    fn.argtypes = _SIGNATURES[symbol]
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


# ------------------------------------------------------------------ layout

def channel_layout(c: int, dtype: torch.dtype, aligned: bool = True
                   ) -> Tuple[int, int, int]:
    """(vec, cvp, c_tiles) of the kernels' CTAs for C channels: `vec`
    channels per load (16 bytes when C and the pointer allow, else 1), `cvp`
    lanes over one row's C / vec vectors (the power of two at or above it,
    at most 32), `c_tiles` CTAs across the channels."""
    wide = 128 // torch.finfo(dtype).bits
    vec = wide if aligned and c % wide == 0 else 1
    cv = c // vec
    cvp = 32 if cv > 32 else 1 << (cv - 1).bit_length()
    return vec, cvp, -(-cv // cvp)


def moment_chunk_rows(rows: int, c: int, dtype: torch.dtype,
                      aligned: bool = True, sms: int = H100_SMS) -> int:
    """Rows per K5 pass-1 chunk: enough chunks that the CTAs fill `sms` SMs
    MOMENT_CTAS_PER_SM times, each chunk at least MIN_CHUNK_ROWS rows, a
    multiple of 64. The card checks drop one such chunk as their control."""
    _, _, c_tiles = channel_layout(c, dtype, aligned)
    chunks = max(1, sms * MOMENT_CTAS_PER_SM // c_tiles)
    per = max(MIN_CHUNK_ROWS, -(-rows // chunks))
    return -(-per // 64) * 64


def _check_x(x: torch.Tensor, name: str) -> None:
    if x.dim() != 4:
        raise ValueError(f"{name} takes an NHWC (B, H, W, C) tensor, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype}, need one of float32, "
                        "bfloat16, float16")
    if x.numel() == 0:
        raise ValueError(f"{name}: empty tensor")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous NHWC tensor")


def _check_activation(activation: str) -> None:
    if activation not in ACTIVATIONS:
        raise ValueError(activation)


def _aligned(x: torch.Tensor) -> bool:
    return x.data_ptr() % 16 == 0


# ------------------------------------------------------------ plain versions

def batch_moments_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's function in plain torch: per-channel fp32 mean and biased
    var = E[x^2] - mean^2 over all B*H*W rows, unclamped, as JAX computes
    them from its kernel's sums."""
    c = x.shape[-1]
    rows = x.numel() // c
    xf = x.reshape(rows, c).float()
    mean = xf.sum(0) / rows
    return mean, (xf * xf).sum(0) / rows - mean * mean


def _activate(y: torch.Tensor, activation: str, slope: float) -> torch.Tensor:
    _check_activation(activation)
    if activation == "leaky_relu":
        return torch.where(y >= 0, y, y * slope)
    if activation == "relu":
        return torch.relu(y)
    if activation == "silu":
        return y * torch.sigmoid(y)
    return y


def _normalize_plain(x, mean, inv, scale, bias, activation, slope):
    y = (x.float() - mean) * inv * scale + bias
    return _activate(y, activation, slope).to(x.dtype)


def apply_bn_act_plain(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                       scale: torch.Tensor, bias: torch.Tensor, *,
                       eps: float = 1e-5, activation: str = "leaky_relu",
                       slope: float = 0.01) -> torch.Tensor:
    """K6's function in plain torch: ((x - mean) * rsqrt(var + eps)) * scale
    + bias in fp32, then the activation, in x's dtype."""
    _check_activation(activation)
    inv = torch.rsqrt(var.float() + eps)
    return _normalize_plain(x, mean.float(), inv, scale.float(), bias.float(),
                            activation, slope)


# ------------------------------------------------------------------ wrappers

def batch_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: per-channel (mean, var) of an NHWC tensor, fp32 (C,) each."""
    _check_x(x, "batch_moments")
    if x.device.type == "cpu":
        return batch_moments_plain(x)
    c = x.shape[-1]
    rows = x.numel() // c
    aligned = _aligned(x)
    vec, cvp, _ = channel_layout(c, x.dtype, aligned)
    sms = _sm_count(x.device.index)
    per = moment_chunk_rows(rows, c, x.dtype, aligned, sms)
    n_chunks = -(-rows // per)
    partials = torch.empty((2, n_chunks, c), dtype=torch.float32,
                           device=x.device)
    stats = torch.empty((2, c), dtype=torch.float32, device=x.device)
    _launch("cid_bn_moments", x.device, x, partials[0], partials[1], stats[0],
            stats[1], rows, c, vec, cvp, per, n_chunks, _DTYPE_CODES[x.dtype])
    batch_moments.launches += 1
    return stats[0], stats[1]


def _check_stats(x: torch.Tensor, **stats: torch.Tensor) -> None:
    c = x.shape[-1]
    for name, t in stats.items():
        if t.shape != (c,):
            raise ValueError(f"{name} {tuple(t.shape)} does not match the "
                             f"{c} channels of x")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_floating_point():
            raise TypeError(f"{name}: dtype {t.dtype}, need a float type")


def apply_bn_act(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                 scale: torch.Tensor, bias: torch.Tensor, *, eps: float = 1e-5,
                 activation: str = "leaky_relu",
                 slope: float = 0.01) -> torch.Tensor:
    """K6: normalize + affine + activation in one pass, in x's dtype. inv =
    rsqrt(var + eps) is computed here, outside the kernel, as JAX does."""
    _check_x(x, "apply_bn_act")
    _check_stats(x, mean=mean, var=var, scale=scale, bias=bias)
    _check_activation(activation)
    if x.device.type == "cpu":
        return apply_bn_act_plain(x, mean, var, scale, bias, eps=eps,
                                  activation=activation, slope=slope)
    c = x.shape[-1]
    rows = x.numel() // c
    mean, scale, bias = (t.float().contiguous() for t in (mean, scale, bias))
    inv = torch.rsqrt(var.float() + eps)
    out = torch.empty_like(x)
    vec, cvp, c_tiles = channel_layout(c, x.dtype,
                                       _aligned(x) and _aligned(out))
    sms = _sm_count(x.device.index)
    # 8 CTAs of 256 threads fill an SM; a grid-stride loop covers the rest
    blocks = max(1, min(-(-rows // (THREADS // cvp)),
                        sms * 8 // c_tiles))
    _launch("cid_bn_apply", x.device, x, mean, inv, scale, bias, out, rows, c,
            vec, cvp, blocks, ACTIVATIONS.index(activation), float(slope),
            _DTYPE_CODES[x.dtype])
    apply_bn_act.launches += 1
    return out


for _wrapper in (batch_moments, apply_bn_act):
    _wrapper.launches = 0


def fused_bn_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                 eps: float = 1e-5, activation: str = "leaky_relu",
                 slope: float = 0.01):
    """Train-mode BatchNorm + activation on one device (K5 then K6).
    Returns (y, mean, var): the moments feed running-stat updates."""
    mean, var = batch_moments(x)
    y = apply_bn_act(x, mean, var, scale, bias, eps=eps,
                     activation=activation, slope=slope)
    return y, mean, var


def sync_batch_norm_act(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, *, eps: float = 1e-5,
                        activation: str = "leaky_relu", slope: float = 0.01,
                        group: Optional[object] = None):
    """Cross-process SyncBN (the JAX package's psum over a mesh axis): the
    local moments (K5) are all-reduced over the `torch.distributed` group,
    then each process normalizes its shard (K6). As in JAX, n is the number
    of processes, g_mean = sum(mean) / n and g_var = sum(var + mean^2) / n -
    g_mean^2: the moments of the union only when every shard has the same
    number of rows; unequal shards are weighted equally."""
    import torch.distributed as dist

    mean, var = batch_moments(x)
    n = torch.ones((), dtype=torch.float32, device=x.device)
    g_sum = mean.clone()
    g_sq = var + mean * mean
    for t in (n, g_sum, g_sq):
        dist.all_reduce(t, group=group)
    g_mean = g_sum / n
    g_var = g_sq / n - g_mean * g_mean
    y = apply_bn_act(x, g_mean, g_var, scale, bias, eps=eps,
                     activation=activation, slope=slope)
    return y, g_mean, g_var
