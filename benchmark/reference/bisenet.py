"""BiSeNet 19-class face parser, counterpart of the JAX package's
models/bisenet.py (the reference parser: a ResNet-18 context path with two
attention-refinement modules and global context, the res3 feature standing
in for the spatial path, SE-style feature fusion and three logit heads
upsampled with align_corners=True bilinear).

The modules run NCHW with torch's OIHW weights; `BiSeNet` takes and returns
NHWC, as the JAX module does. Module and parameter names are the flax ones,
so `state_from_jax` carries JAX parameters and batch statistics across.
BatchNorm (`BatchNorm`) is flax's: in eval mode the running statistics
(eps 1e-5); in train mode (`model.train()`, training/bisenet_train.py) the
batch's fp32 mean and mean of squares, averaged over a `torch.distributed`
group when `set_sync_group` gave one (SyncBN: JAX's BatchNorm with
`axis_name`, the reference's InPlaceABNSync), var = max(0, E[x^2] -
E[x]^2), and the running statistics updated with flax's momentum,
ra = 0.9 ra + 0.1 batch, the variance biased. The fused kernels of
ops/fused_bn_act.py are not wired in, as the JAX package does not wire its
own.
"""
from __future__ import annotations

from typing import Mapping, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .image import imagenet_preprocess

BN_EPS = 1e-5


def resize_bilinear_align_corners(x: torch.Tensor,
                                  size: Tuple[int, int]) -> torch.Tensor:
    """NCHW bilinear resize with align_corners=True (the reference's
    F.interpolate; the JAX package spells it out on NHWC)."""
    return F.interpolate(x, size=size, mode="bilinear", align_corners=True)


class BatchNorm(nn.BatchNorm2d):
    """NCHW BatchNorm; the reference runs it in eval mode only (the
    running statistics, eps 1e-5)."""


def _bn(channels: int) -> BatchNorm:
    return BatchNorm(channels, eps=BN_EPS)


def _conv(cin: int, cout: int, ks: int, stride: int = 1, padding: int = 0,
          bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, ks, stride, padding, bias=bias)


class ConvBNReLU(nn.Module):
    def __init__(self, in_chan: int, out_chan: int, ks: int = 3,
                 stride: int = 1, padding: int = 1):
        super().__init__()
        self.conv = _conv(in_chan, out_chan, ks, stride, padding)
        self.bn = _bn(out_chan)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    def __init__(self, in_chan: int, out_chan: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(in_chan, out_chan, 3, stride, 1)
        self.bn1 = _bn(out_chan)
        self.conv2 = _conv(out_chan, out_chan, 3, 1, 1)
        self.bn2 = _bn(out_chan)
        self.has_downsample = in_chan != out_chan or stride != 1
        if self.has_downsample:
            self.downsample_conv = _conv(in_chan, out_chan, 1, stride)
            self.downsample_bn = _bn(out_chan)

    def forward(self, x):
        residual = F.relu(self.bn1(self.conv1(x)))
        residual = self.bn2(self.conv2(residual))
        shortcut = x
        if self.has_downsample:
            shortcut = self.downsample_bn(self.downsample_conv(x))
        return F.relu(shortcut + residual)


class Resnet18(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2, 3)
        self.bn1 = _bn(64)
        self.layer1_0 = BasicBlock(64, 64)
        self.layer1_1 = BasicBlock(64, 64)
        self.layer2_0 = BasicBlock(64, 128, 2)
        self.layer2_1 = BasicBlock(128, 128)
        self.layer3_0 = BasicBlock(128, 256, 2)
        self.layer3_1 = BasicBlock(256, 256)
        self.layer4_0 = BasicBlock(256, 512, 2)
        self.layer4_1 = BasicBlock(512, 512)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)   # flax pads with -inf, as torch does
        x = self.layer1_1(self.layer1_0(x))
        feat8 = self.layer2_1(self.layer2_0(x))
        feat16 = self.layer3_1(self.layer3_0(feat8))
        feat32 = self.layer4_1(self.layer4_0(feat16))
        return feat8, feat16, feat32


class AttentionRefinementModule(nn.Module):
    def __init__(self, in_chan: int, out_chan: int):
        super().__init__()
        self.conv = ConvBNReLU(in_chan, out_chan)
        self.conv_atten = _conv(out_chan, out_chan, 1)
        self.bn_atten = _bn(out_chan)

    def forward(self, x):
        feat = self.conv(x)
        atten = feat.mean(dim=(2, 3), keepdim=True)
        atten = self.bn_atten(self.conv_atten(atten))
        return feat * torch.sigmoid(atten)


def _nearest(x: torch.Tensor, size) -> torch.Tensor:
    # jax.image.resize "nearest" samples at half-pixel centres: nearest-exact
    return F.interpolate(x, size=tuple(size), mode="nearest-exact")


class ContextPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnet = Resnet18()
        self.conv_avg = ConvBNReLU(512, 128, ks=1, padding=0)
        self.arm32 = AttentionRefinementModule(512, 128)
        self.conv_head32 = ConvBNReLU(128, 128)
        self.arm16 = AttentionRefinementModule(256, 128)
        self.conv_head16 = ConvBNReLU(128, 128)

    def forward(self, x):
        feat8, feat16, feat32 = self.resnet(x)
        avg = self.conv_avg(feat32.mean(dim=(2, 3), keepdim=True))
        feat32_sum = self.arm32(feat32) + avg
        feat32_up = self.conv_head32(_nearest(feat32_sum, feat16.shape[2:]))
        feat16_sum = self.arm16(feat16) + feat32_up
        feat16_up = self.conv_head16(_nearest(feat16_sum, feat8.shape[2:]))
        return feat8, feat16_up, feat32_up


class FeatureFusionModule(nn.Module):
    def __init__(self, in_chan: int, out_chan: int):
        super().__init__()
        self.convblk = ConvBNReLU(in_chan, out_chan, ks=1, padding=0)
        self.conv1 = _conv(out_chan, out_chan // 4, 1)
        self.conv2 = _conv(out_chan // 4, out_chan, 1)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], dim=1))
        atten = feat.mean(dim=(2, 3), keepdim=True)
        atten = torch.sigmoid(self.conv2(F.relu(self.conv1(atten))))
        return feat * atten + feat


class BiSeNetOutput(nn.Module):
    def __init__(self, in_chan: int, mid_chan: int, n_classes: int):
        super().__init__()
        self.conv = ConvBNReLU(in_chan, mid_chan)
        self.conv_out = _conv(mid_chan, n_classes, 1)

    def forward(self, x):
        return self.conv_out(self.conv(x))


class BiSeNet(nn.Module):
    """x (B, H, W, 3) ImageNet-normalized -> three (B, H, W, n_classes)
    logit maps (main, aux16, aux32), as the JAX module."""

    def __init__(self, n_classes: int = 19):
        super().__init__()
        self.n_classes = n_classes
        self.cp = ContextPath()
        self.ffm = FeatureFusionModule(256, 256)
        self.conv_out = BiSeNetOutput(256, 256, n_classes)
        self.conv_out16 = BiSeNetOutput(128, 64, n_classes)
        self.conv_out32 = BiSeNetOutput(128, 64, n_classes)

    def forward(self, x: torch.Tensor):
        return tuple(o.permute(0, 2, 3, 1)
                     for o in self.forward_nchw(x.permute(0, 3, 1, 2)))

    def forward_nchw(self, x: torch.Tensor):
        size = tuple(x.shape[2:])
        feat_res8, feat_cp8, feat_cp16 = self.cp(x)
        out = self.conv_out(self.ffm(feat_res8, feat_cp8))
        out16 = self.conv_out16(feat_cp8)
        out32 = self.conv_out32(feat_cp16)
        return tuple(resize_bilinear_align_corners(o, size)
                     for o in (out, out16, out32))


def make_face_parser(state: Mapping[str, torch.Tensor], size: int = 512,
                     device: Union[str, torch.device] = "cuda"):
    """(H, W, 3) uint8 image -> (size, size) uint8 label map: the pipeline's
    `face_parser` hook (JAX make_face_parser; reference parsing_face_mask).
    `state`: a BiSeNet state dict (e.g. from `state_from_jax`); the model
    runs in fp32 on `device`."""
    device = torch.device(device)
    n_classes = state["conv_out.conv_out.weight"].shape[0]
    with torch.device("meta"):
        model = BiSeNet(n_classes)
    model.load_state_dict(state, assign=True)
    model = model.to(device=device, dtype=torch.float32).eval()

    @torch.no_grad()
    def parse(image: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(imagenet_preprocess(image, size)).to(device)
        logits = model.forward_nchw(x.permute(0, 3, 1, 2))[0]
        return logits.argmax(dim=1)[0].to(torch.uint8).cpu().numpy()

    parse.model = model
    return parse
