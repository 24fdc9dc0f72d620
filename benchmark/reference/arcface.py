"""ArcFace face-recognition embedder (iresnet backbone), counterpart of the
JAX package's models/arcface.py: a stride-1 3x3 stem, pre-activation
IBasicBlocks with per-channel PReLU, then BN -> flatten -> FC -> feature BN,
112 x 112 input -> 512-d embedding (w600k_r50 = iresnet50).

The modules run NCHW and flatten (C, H, W) before `fc`, as the insightface
original does; `state_from_jax(..., flatten_nhwc={"fc": 512})` permutes the
JAX package's (H, W, C)-flattened fc kernel to match. `IResNet` takes
(B, H, W, 3) as the JAX module does.
"""
from __future__ import annotations

from typing import Callable, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from .image import resize_bilinear_uint8

BN_EPS = 1e-5
IRESNET_LAYERS = {
    "iresnet18": (2, 2, 2, 2),
    "iresnet34": (3, 4, 6, 3),
    "iresnet50": (3, 4, 14, 3),
    "iresnet100": (3, 13, 30, 3),
}
CHANNELS = (64, 128, 256, 512)


class PReLU(nn.Module):
    """Per-channel PReLU over dim 1 (torch nn.PReLU(num_parameters=C))."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x):
        alpha = self.weight.to(x.dtype).view(1, -1, *([1] * (x.dim() - 2)))
        return torch.where(x >= 0, x, alpha * x)


class IBasicBlock(nn.Module):
    def __init__(self, in_chan: int, out_chan: int, stride: int = 1):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(in_chan, eps=BN_EPS)
        self.conv1 = nn.Conv2d(in_chan, out_chan, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(out_chan, eps=BN_EPS)
        self.prelu = PReLU(out_chan)
        self.conv2 = nn.Conv2d(out_chan, out_chan, 3, stride, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out_chan, eps=BN_EPS)
        self.has_downsample = stride != 1 or in_chan != out_chan
        if self.has_downsample:
            self.downsample_conv = nn.Conv2d(in_chan, out_chan, 1, stride,
                                             bias=False)
            self.downsample_bn = nn.BatchNorm2d(out_chan, eps=BN_EPS)

    def forward(self, x):
        h = self.bn2(self.conv1(self.bn1(x)))
        h = self.bn3(self.conv2(self.prelu(h)))
        shortcut = x
        if self.has_downsample:
            shortcut = self.downsample_bn(self.downsample_conv(x))
        return h + shortcut


class IResNet(nn.Module):
    """x (B, S, S, 3) normalized to [-1, 1] -> (B, embedding_dim)."""

    def __init__(self, layers: Tuple[int, ...] = IRESNET_LAYERS["iresnet50"],
                 embedding_dim: int = 512, input_size: int = 112):
        super().__init__()
        self.layers = tuple(layers)
        self.input_size = input_size
        self.conv1 = nn.Conv2d(3, 64, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=BN_EPS)
        self.prelu = PReLU(64)
        in_chan = 64
        for li, (n_blocks, ch) in enumerate(zip(self.layers, CHANNELS)):
            for bi in range(n_blocks):
                self.add_module(f"layer{li + 1}_{bi}", IBasicBlock(
                    in_chan, ch, 2 if bi == 0 else 1))
                in_chan = ch
        self.bn2 = nn.BatchNorm2d(512, eps=BN_EPS)
        spatial = input_size // 16
        self.fc = nn.Linear(512 * spatial * spatial, embedding_dim)
        self.features = nn.BatchNorm1d(embedding_dim, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_nchw(x.permute(0, 3, 1, 2))

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        h = self.prelu(self.bn1(self.conv1(x)))
        for li, n_blocks in enumerate(self.layers):
            for bi in range(n_blocks):
                h = getattr(self, f"layer{li + 1}_{bi}")(h)
        h = self.bn2(h).flatten(1)     # (C, H, W) order, as insightface
        return self.features(self.fc(h))


def normalized_embedding(embedding: torch.Tensor) -> torch.Tensor:
    """insightface `normed_embedding` (L2-normalized)."""
    return embedding / torch.linalg.vector_norm(embedding, dim=-1,
                                                keepdim=True)


def iresnet_arch_from_params(state: Mapping[str, torch.Tensor]):
    """(layers, embedding_dim, input_size) read off an IResNet state dict,
    so r50, r100 and tiny weights all build the right model."""
    layers = []
    for li in range(1, 5):
        n = 0
        while f"layer{li}_{n}.conv1.weight" in state:
            n += 1
        layers.append(n)
    embedding_dim = int(state["fc.bias"].shape[0])
    c = int(state["bn2.weight"].shape[0])
    spatial = int(round((state["fc.weight"].shape[1] // c) ** 0.5))
    return tuple(layers), embedding_dim, spatial * 16


def make_face_embedder(state: Mapping[str, torch.Tensor],
                       variant: Optional[str] = None,
                       detector: Optional[Callable] = None,
                       allow_center_crop: bool = False,
                       device: Union[str, torch.device] = "cuda"):
    """(H, W, 3) uint8 image -> (1, D) L2-normalized numpy embedding: the
    pipeline's `face_embedder` hook (JAX make_face_embedder; reference
    FaceAnalysis detect -> align -> embed).

    detector: a `models.scrfd.make_face_detector` callable (image ->
    (aligned (S, S, 3) float in [0, 255], score, box)); a score <= 0 gives
    the reference's zero embedding. allow_center_crop: the opt-in,
    detector-free center crop for pre-aligned inputs; with neither, the call
    is a configuration error. The model runs in fp32 on `device`."""
    if detector is None and not allow_center_crop:
        raise ValueError(
            "make_face_embedder needs a face detector (models.scrfd."
            "make_face_detector) or allow_center_crop=True for pre-aligned "
            "inputs")
    device = torch.device(device)
    layers, embedding_dim, input_size = iresnet_arch_from_params(state)
    if variant is not None:
        layers = IRESNET_LAYERS[variant]
    with torch.device("meta"):
        model = IResNet(layers, embedding_dim, input_size)
    model.load_state_dict(state, assign=True)
    model = model.to(device=device, dtype=torch.float32).eval()

    @torch.no_grad()
    def embed(image: np.ndarray) -> np.ndarray:
        if detector is not None:
            aligned, score, _ = detector(image)
            if score <= 0.0:  # reference :220-221
                return np.zeros((1, embedding_dim), np.float32)
            arr = np.asarray(aligned, np.float32)
            if arr.shape[0] != input_size:
                arr = resize_bilinear_uint8(
                    arr.astype(np.uint8), input_size,
                    input_size).astype(np.float32)
        else:
            h, w = image.shape[:2]
            side = min(w, h)
            top, left = (h - side) // 2, (w - side) // 2
            crop = image[top:top + side, left:left + side]
            arr = resize_bilinear_uint8(crop, input_size,
                                        input_size).astype(np.float32)
        x = torch.from_numpy(arr / 127.5 - 1.0).to(device)[None]
        return normalized_embedding(model(x)).cpu().numpy()

    embed.model = model
    embed.detector = detector
    return embed
