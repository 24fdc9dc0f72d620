"""W8A8 int8 products of the quantized UNet (the JAX package's ops/quant.py).

Weights are quantized symmetrically per output channel from the LoRA-folded
float weights, once per generate() call (`quantize_state_like`).
Activations are quantized per example (convolutions) or per token (linear
layers) on every call, or, in the calibrated static mode, with one fixed
per-tensor scale per layer (`quantize_with_scale`). The products run
int8 x int8 -> int32, and the dequant epilogue is the JAX package's: the
int32 result cast to fp32 times (activation scale * kernel scale), that
product formed first, then the bias in fp32, then the compute dtype.

The JAX package's products are XLA's, not Pallas kernels; no TPU kernel is
ported here. On the card the products go to `torch._int_mm` (cuBLASLt's
int8 GEMM, int32 result) through `int_mm`:
  - a linear layer's activations reshaped to (tokens, in_features);
  - a convolution's as an im2col matrix copied from padded, strided views
    of the int8 NHWC activations (columns ordered (kh, kw, cin), the
    kernel reshaped to match), stride and 1x1 convolutions by the same
    code.
`_int_mm` takes m > 16 and k, n multiples of 8: m is padded with zero rows
up to 17 (exact), and any other k or n raises a ValueError naming the
layer. No SD1.5 or SDXL quantized layer has such a k or n. Nothing falls
back to a float product: a card whose PyTorch lacks `_int_mm`, or a call it
refuses, fails the run.

`int_mm_plain` is the exact integer product on the CPU: the int8 values
multiplied and summed in float64, where every product (at most 127^2) and
every partial sum (at most k * 127^2, far below 2^53 for any k here) is an
integer held exactly, so the result is the int64 sum, whatever the order.
A CPU tensor takes it; on the card it is what `_int_mm` is held against,
bit for bit. `int_mm.launches` counts the calls that went to `_int_mm`.

Calibration (models/layers.py `calibration(model)`): inside it, every
dynamic int8 layer of the model records max(its activation scales) * 127
under its module path, as the JAX layers sow `act_amax` into the "calib"
collection. `act_scales_from_calib` and `merge_act_scales` turn the
records into the nested {module: {"act_scale": scale}} tree the static
layers read, keyed by the JAX package's module paths (io/quant_scales.py
saves it).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

_EPS = 1e-8
QMAX = 127.0
# cuBLASLt's int8 GEMM through torch._int_mm: m above 16, k and n
# multiples of 8
INT_MM_MIN_M = 17
INT_MM_ALIGN = 8


def quantize_symmetric(x: torch.Tensor, dims: Sequence[int],
                       keepdim: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8: scale = max(amax over `dims`, 1e-8) / 127, q =
    round-half-even(x / scale) clipped to +-127. Returns (q int8, scale
    fp32)."""
    xf = x.float()
    amax = xf.abs().amax(dim=tuple(dims), keepdim=True)
    scale = amax.clamp_min(_EPS) / QMAX
    q = torch.clamp(torch.round(xf / scale), -QMAX, QMAX).to(torch.int8)
    if not keepdim:
        scale = scale.squeeze(tuple(dims))
    return q, scale


def quantize_conv_kernel(w: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW kernel -> (int8 OIHW, (O,) fp32 per-output-channel scale)."""
    return quantize_symmetric(w, (1, 2, 3))


def quantize_dense_kernel(w: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, I) weight -> (int8 (O, I), (O,) fp32 scale)."""
    return quantize_symmetric(w, (1,))


def quantize_with_scale(x: torch.Tensor, scale: torch.Tensor
                        ) -> torch.Tensor:
    """int8 with a fixed (calibrated) scale: round(x / scale) clipped."""
    return torch.clamp(torch.round(x.float() / scale), -QMAX,
                       QMAX).to(torch.int8)


def int_mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact (module
    docstring: float64 holds every partial sum exactly)."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


def int_mm(a: torch.Tensor, b: torch.Tensor, name: str = "") -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32. A CPU tensor takes the
    plain product; a CUDA one `torch._int_mm`, m padded to 17 with zero
    rows, or raises (k, n not multiples of 8: a ValueError naming the
    layer `name`)."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"{name}: int_mm takes int8, got {a.dtype} and "
                        f"{b.dtype}")
    if a.device.type != "cuda":
        return int_mm_plain(a, b)
    m, k = a.shape
    n = b.shape[1]
    if k % INT_MM_ALIGN or n % INT_MM_ALIGN:
        raise ValueError(f"{name or 'int_mm'}: torch._int_mm takes k and n "
                         f"multiples of {INT_MM_ALIGN}, got k={k}, n={n}")
    if m < INT_MM_MIN_M:
        a = torch.cat([a, a.new_zeros((INT_MM_MIN_M - m, k))])
    out = torch._int_mm(a, b)
    int_mm.launches += 1
    return out[:m] if m < INT_MM_MIN_M else out


int_mm.launches = 0


def im2col_int8(xq: torch.Tensor, kernel_size: Tuple[int, int],
                stride: int, padding: int) -> Tuple[torch.Tensor, int, int]:
    """int8 (B, C, H, W) activations (any strides) -> ((B*Ho*Wo, kh*kw*C)
    int8 matrix, Ho, Wo): one copy into a zero-padded NHWC buffer, then
    the patches of a strided view of it, columns ordered (kh, kw, c). A 1x1
    convolution without stride or padding is the NHWC view itself."""
    b, c, h, w = xq.shape
    kh, kw = kernel_size
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    if (kh, kw, stride, padding) == (1, 1, 1, 0):
        return xq.permute(0, 2, 3, 1).reshape(b * h * w, c), ho, wo
    hp, wp = h + 2 * padding, w + 2 * padding
    xp = xq.new_zeros((b, hp, wp, c))
    xp[:, padding:padding + h, padding:padding + w] = xq.permute(0, 2, 3, 1)
    cols = xp.as_strided((b, ho, wo, kh, kw, c),
                         (hp * wp * c, stride * wp * c, stride * c, wp * c,
                          c, 1))
    return cols.reshape(b * ho * wo, kh * kw * c), ho, wo


def conv_weight_matrix(kernel_q: torch.Tensor) -> torch.Tensor:
    """int8 (Cout, Cin, kh, kw) -> the (kh*kw*Cin, Cout) matrix of
    `im2col_int8`'s column order (the transpose of a contiguous (Cout,
    K) copy: column-major, the layout cuBLASLt's int8 GEMM reads)."""
    cout = kernel_q.shape[0]
    return kernel_q.permute(0, 2, 3, 1).reshape(cout, -1).t()


def int8_conv_quantized(xq: torch.Tensor, xscale: torch.Tensor,
                        kernel_q: torch.Tensor, kernel_scale: torch.Tensor,
                        stride: int = 1, padding: int = 0,
                        name: str = "") -> torch.Tensor:
    """Convolution of quantized activations: xq int8 (B, Cin, H, W),
    xscale (B, 1, 1, 1) or a scalar, kernel_q int8 (Cout, Cin, kh, kw),
    kernel_scale (Cout,). Returns fp32 (B, Cout, Ho, Wo), laid out NHWC
    in memory (the product's own layout)."""
    b = xq.shape[0]
    cout, _, kh, kw = kernel_q.shape
    cols, ho, wo = im2col_int8(xq, (kh, kw), stride, padding)
    y = int_mm(cols, conv_weight_matrix(kernel_q), name).view(
        b, ho, wo, cout).permute(0, 3, 1, 2)
    scale = xscale.reshape(-1, 1, 1, 1) * kernel_scale.reshape(1, -1, 1, 1)
    return y.float() * scale


def int8_matmul_quantized(xq: torch.Tensor, xscale: torch.Tensor,
                          kernel_q: torch.Tensor, kernel_scale: torch.Tensor,
                          name: str = "") -> torch.Tensor:
    """xq int8 (..., I) @ kernel_q int8 (O, I)^T, dequantized by xscale
    ((..., 1) or a scalar) * kernel_scale (O,). Returns fp32 (..., O)."""
    lead = xq.shape[:-1]
    y = int_mm(xq.reshape(-1, xq.shape[-1]), kernel_q.t(), name)
    y = y.view(*lead, kernel_q.shape[0])
    return y.float() * (xscale * kernel_scale)


# ---------------------------------------------------------------- calibration

def act_scales_from_calib(records: Mapping[str, Sequence[torch.Tensor]],
                          margin: float = 1.0) -> Dict:
    """Records of `calibration(model)` -> the act_scale tree: per module path,
    max over its applies * margin, at least 1e-8, over 127 (plain max
    calibration; margin > 1 leaves headroom for inputs beyond the
    calibration set). Leaves are 0-dim fp32 tensors."""
    tree: Dict = {}
    for path, values in records.items():
        amax = torch.stack(list(values)).amax()
        node = tree
        for part in path.split("."):
            node = node.setdefault(part, {})
        node["act_scale"] = (amax * margin).clamp_min(_EPS) / QMAX
    return tree


def merge_act_scales(trees: Sequence[Mapping]) -> Dict:
    """Elementwise max of act_scale trees (steps, batches, samples)."""
    merged: Dict = {}
    for tree in trees:
        for key, val in tree.items():
            if key == "act_scale":
                merged[key] = (val if key not in merged
                               else torch.maximum(torch.as_tensor(
                                   merged[key]), torch.as_tensor(val)))
            else:
                merged[key] = merge_act_scales(
                    [merged[key], val] if key in merged else [val])
    return merged


def act_scales_to_numpy(tree: Mapping) -> Dict:
    """An act_scale tree with numpy fp32 leaves (the host copy a bundle
    keeps and io/quant_scales.py writes)."""
    return {k: (act_scales_to_numpy(v) if isinstance(v, Mapping)
                else np.asarray(torch.as_tensor(v).detach().cpu(),
                                np.float32))
            for k, v in tree.items()}


def _tree_leaf(tree: Optional[Mapping], path: str):
    node = tree
    for part in path.split("."):
        if not isinstance(node, Mapping) or part not in node:
            return None
        node = node[part]
    return node.get("act_scale") if isinstance(node, Mapping) else None


def quantize_state_like(target: Mapping[str, torch.Tensor],
                        state: Mapping[str, torch.Tensor],
                        act_scales: Optional[Mapping] = None
                        ) -> Dict[str, torch.Tensor]:
    """A float state dict -> the one a quantized model expects (the JAX
    package's quantize_params_like). `target` is the quantized model's
    state dict (meta tensors do): each `P.kernel_q` with `P.kernel_scale`
    comes from the float `P.weight` (rank 4: a convolution, per output
    channel over (1, 2, 3); rank 2: a linear layer, over (1,)), each
    `P.act_scale` from `act_scales` at P's module path, and every other
    entry is passed through. A static target without its calibrated scale
    raises: serving an uncalibrated scale would corrupt the output."""
    out: Dict[str, torch.Tensor] = {}
    for key in target:
        prefix, _, leaf = key.rpartition(".")
        if leaf == "kernel_scale":
            continue                     # made with kernel_q
        if leaf == "kernel_q":
            w = state[f"{prefix}.weight"]
            if w.dim() == 4:
                q, s = quantize_conv_kernel(w)
            elif w.dim() == 2:
                q, s = quantize_dense_kernel(w)
            else:
                raise ValueError(f"{prefix}: kernel of rank {w.dim()}")
            out[key], out[f"{prefix}.kernel_scale"] = q, s
        elif leaf == "act_scale":
            val = _tree_leaf(act_scales, prefix)
            if val is None:
                raise ValueError(
                    f"{prefix}: the static int8 model needs calibrated "
                    "act_scales (pipeline.calibrate_int8)")
            device = state[f"{prefix}.weight"].device
            out[key] = torch.tensor(np.asarray(val, np.float32)
                                    if not isinstance(val, torch.Tensor)
                                    else val).to(device).reshape(())
        else:
            out[key] = state[key]
    return out
