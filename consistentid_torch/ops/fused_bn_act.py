"""Fused BatchNorm + activation: the hand-written CUDA kernels K5 and K6,
their plain PyTorch versions, and the cross-process SyncBN variant.

The kernels replace the JAX package's Pallas TPU kernels
(consistentid_tpu/ops/fused_bn_act.py):
  K5 `batch_moments` <- `_moments_kernel`    (csrc/fused_bn_act.cu)
  K6 `apply_bn_act`  <- `_normalize_kernel`  (csrc/fused_bn_act.cu)
The source's header states what bounds them on an H100 (bytes, and at
small shapes what a call costs besides them) and how the design answers:
each is one launch. K5 is a persistent grid of thread block clusters whose
sums meet in distributed shared memory and then in the cluster that draws
the last ticket, in an order fixed by the shape, so its bits repeat from
call to call (`consistentid_torch.testing.moments_in_kernel_order` gives
them in plain torch). K6 computes rsqrt(var + eps) in its prologue.
`bn_plan` is the launch: what it returns is what the kernels run with.

Every function takes NHWC tensors (B, H, W, C), as the JAX package does, of
float32, bfloat16 or float16; statistics are fp32 (C,). A CUDA tensor
launches the kernel or raises; a CPU tensor takes the plain version
(`batch_moments_plain`, `apply_bn_act_plain`), which is also what each
kernel is held against on the card. Each launch adds one to the wrapper's
`.launches`.

`fused_bn_act` is K5 then K6 (train-mode BatchNorm + activation on one
device, the InPlaceABN equivalent), K6 launched with programmatic dependent
launch so that it starts while K5 ends; `sync_batch_norm_act` all-reduces
the moments over a `torch.distributed` group first. No model of the port
calls them, as no model of the JAX package does: its BiSeNet, ArcFace and
SCRFD use a plain BatchNorm.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from .build import load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ACTIVATIONS = ("leaky_relu", "relu", "silu", "identity")
THREADS = 256             # CTA size of both kernels
H100_SMS = 132
MOMENT_CTAS_PER_SM = 2    # K5: a persistent grid of about 2 CTAs an SM,
MIN_CTA_ROWS = 256        # ... each summing at least this many rows
MAX_CLUSTER = 8           # K5: CTAs of a cluster, the portable most
FINAL_ROWS_IN_FLIGHT = 16  # K5: partial rows a lane of the last cluster
#                            loads at once
APPLY_CTAS_PER_SM = 8     # K6: CTAs of 256 threads resident on an SM
# K6: rows a thread loads at once (the kernel's), by x's dtype
APPLY_ROWS_IN_FLIGHT = {torch.float32: 4, torch.bfloat16: 8,
                        torch.float16: 8}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_SIGNATURES = {
    "cid_bn_moments": [_P] * 6 + [_L, _I, _I, _I, _L, _I, _I, _I, _I, _P],
    "cid_bn_apply": [_P] * 6 + [_L, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I,
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


# K5's ticket counters, one uint32 per channel tile, per (device, stream):
# zeroed when made, left zeroed by every launch.
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


def _ticket_counters(device: torch.device, tiles: int) -> torch.Tensor:
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device.index, stream)
    counters = _tickets.get(key)
    if counters is None or counters.numel() < tiles:
        counters = torch.zeros(max(tiles, 64), dtype=torch.int32,
                               device=device)
        _tickets[key] = counters
    return counters


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


@dataclass(frozen=True)
class BNPlan:
    """The launch of K5 and K6 for one shape (`bn_plan`).

    Both: `vec` channels a load, `cvp` lanes over a row's vectors,
    `c_tiles` CTAs across the channels; `row_lanes` = 256 / cvp rows read
    side by side. K5: `ctas` CTAs along the rows, CTA i summing rows
    [i * rows_per_cta, ...), in clusters of `cluster`, one partial row a
    cluster (`partial_rows`), which the last cluster sums over
    `final_lanes` lanes. K6: `apply_blocks` CTAs along the rows, each
    thread keeping `apply_rows_in_flight` rows in flight."""
    vec: int
    cvp: int
    c_tiles: int
    rows_per_cta: int
    ctas: int
    cluster: int
    partial_rows: int
    final_lanes: int
    apply_blocks: int
    apply_rows_in_flight: int

    @property
    def row_lanes(self) -> int:
        return THREADS // self.cvp


def bn_plan(rows: int, c: int, dtype: torch.dtype, aligned: bool = True,
            sms: int = H100_SMS) -> BNPlan:
    """The launch of K5 and K6 for `rows` rows of `c` channels of `dtype`
    (`aligned`: x, and K6's output, on a 16-byte boundary) on a card of
    `sms` SMs.

    K5: about MOMENT_CTAS_PER_SM CTAs an SM over all channel tiles, each
    summing at least MIN_CTA_ROWS rows; from MAX_CLUSTER CTAs on, a
    multiple of it, so that every cluster is whole; below, the largest
    power of two that divides the count. The last CTAs may be short, or
    empty. Each of the 2 * vec * cvp values (S and Q of each channel) of
    the partial rows is summed over the fewest lanes (a power of two, at
    most a warp's 32) that load them in one round of FINAL_ROWS_IN_FLIGHT.
    K6: at most APPLY_CTAS_PER_SM CTAs an SM; of those, the fewest
    that take the row groups (of APPLY_ROWS_IN_FLIGHT[dtype] * row_lanes
    rows) in as few grid-stride rounds, so no CTA takes more than one group
    above another."""
    if rows < 1 or c < 1:
        raise ValueError(f"no rows to plan: {rows} x {c}")
    vec, cvp, c_tiles = channel_layout(c, dtype, aligned)
    ctas = max(1, min(sms * MOMENT_CTAS_PER_SM // c_tiles,
                      rows // MIN_CTA_ROWS))
    if ctas >= MAX_CLUSTER:
        ctas -= ctas % MAX_CLUSTER
    cluster = MAX_CLUSTER
    while ctas % cluster:
        cluster //= 2
    partial_rows = ctas // cluster
    lanes = -(-partial_rows // FINAL_ROWS_IN_FLIGHT)
    final_lanes = min(32, 1 << (lanes - 1).bit_length())
    in_flight = APPLY_ROWS_IN_FLIGHT[dtype]
    groups = -(-rows // (THREADS // cvp * in_flight))
    per_block = -(-groups // max(1, sms * APPLY_CTAS_PER_SM // c_tiles))
    return BNPlan(vec=vec, cvp=cvp, c_tiles=c_tiles,
                  rows_per_cta=-(-rows // ctas), ctas=ctas, cluster=cluster,
                  partial_rows=partial_rows, final_lanes=final_lanes,
                  apply_blocks=-(-groups // per_block),
                  apply_rows_in_flight=in_flight)


def plan_for(x: torch.Tensor) -> BNPlan:
    """`bn_plan` for an NHWC tensor as the wrappers launch it: its pointer's
    alignment, and its card's SM count (H100_SMS for a CPU tensor)."""
    c = x.shape[-1]
    sms = _sm_count(x.device.index) if x.device.type == "cuda" else H100_SMS
    return bn_plan(x.numel() // c, c, x.dtype, _aligned(x), sms)


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
    """K5: per-channel (mean, var) of an NHWC tensor, fp32 (C,) each; one
    launch, the same bits every call."""
    _check_x(x, "batch_moments")
    if x.device.type == "cpu":
        return batch_moments_plain(x)
    return _batch_moments(x, plan_for(x))


def _batch_moments(x: torch.Tensor, plan: BNPlan):
    """K5 launched with `plan`."""
    c = x.shape[-1]
    partials = torch.empty((2, plan.partial_rows, c), dtype=torch.float32,
                           device=x.device)
    stats = torch.empty((2, c), dtype=torch.float32, device=x.device)
    _launch("cid_bn_moments", x.device, x, partials[0], partials[1],
            _ticket_counters(x.device, plan.c_tiles), stats[0], stats[1],
            x.numel() // c, c, plan.vec, plan.cvp, plan.rows_per_cta,
            plan.ctas, plan.cluster, plan.final_lanes,
            _DTYPE_CODES[x.dtype])
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
    """K6: normalize + affine + activation in one pass, in x's dtype; inv =
    rsqrt(var + eps) is computed in the kernel."""
    return _apply_bn_act(x, mean, var, scale, bias, eps, activation, slope,
                         pdl=False)


def _apply_bn_act(x, mean, var, scale, bias, eps, activation, slope,
                  pdl: bool) -> torch.Tensor:
    """apply_bn_act; pdl: launch K6 with programmatic dependent launch, to
    overlap the end of the kernel before it (K5): K6 then loads its first
    rows of x before it waits for that kernel, so the kernel just before
    must not write x."""
    _check_x(x, "apply_bn_act")
    _check_stats(x, mean=mean, var=var, scale=scale, bias=bias)
    _check_activation(activation)
    if x.device.type == "cpu":
        return apply_bn_act_plain(x, mean, var, scale, bias, eps=eps,
                                  activation=activation, slope=slope)
    c = x.shape[-1]
    # no kernel where a statistic is fp32 and contiguous already
    mean, var, scale, bias = (t.float().contiguous()
                              for t in (mean, var, scale, bias))
    out = torch.empty_like(x)
    plan = plan_for(x)
    _launch("cid_bn_apply", x.device, x, mean, var, scale, bias, out,
            x.numel() // c, c, plan.vec, plan.cvp, plan.apply_blocks,
            plan.apply_rows_in_flight, ACTIVATIONS.index(activation),
            float(eps), float(slope), _DTYPE_CODES[x.dtype], int(pdl))
    apply_bn_act.launches += 1
    return out


for _wrapper in (batch_moments, apply_bn_act):
    _wrapper.launches = 0


def fused_bn_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                 eps: float = 1e-5, activation: str = "leaky_relu",
                 slope: float = 0.01):
    """Train-mode BatchNorm + activation on one device: K5, then K6 under
    programmatic dependent launch (two launches). Returns (y, mean, var):
    the moments feed running-stat updates."""
    mean, var = batch_moments(x)
    y = _apply_bn_act(x, mean, var, scale, bias, eps, activation, slope,
                      pdl=True)
    return y, mean, var


def sync_batch_norm_act(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, *, eps: float = 1e-5,
                        activation: str = "leaky_relu", slope: float = 0.01,
                        group: Optional[object] = None):
    """Cross-process SyncBN (the JAX package's psum over a mesh axis): the
    local moments (K5) are all-reduced over the `torch.distributed` group,
    then each process normalizes its shard (K6, under programmatic
    dependent launch after the statistics' last kernel). As in JAX, n is
    the number of processes, g_mean = sum(mean) / n and g_var = sum(var +
    mean^2) / n - g_mean^2: the moments of the union only when every shard
    has the same number of rows; unequal shards are weighted equally."""
    import torch.distributed as dist

    mean, var = batch_moments(x)
    n = torch.ones((), dtype=torch.float32, device=x.device)
    g_sum = mean.clone()
    g_sq = var + mean * mean
    for t in (n, g_sum, g_sq):
        dist.all_reduce(t, group=group)
    g_mean = g_sum / n
    g_var = g_sq / n - g_mean * g_mean
    y = _apply_bn_act(x, g_mean, g_var, scale, bias, eps, activation, slope,
                      pdl=True)
    return y, g_mean, g_var
