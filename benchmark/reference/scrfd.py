"""SCRFD face detector (backbone, PAFPN neck, shared head), counterpart of
the JAX package's models/scrfd.py: a ResNetV1e-style backbone (deep 3x3
stem, 3x3/2 max-pool, BasicBlocks with avg-pool downsample shortcuts), a
path-aggregation FPN over the last three stages and a head whose conv+norm
tower and prediction convs are shared across strides, with a learnable
per-level `scale_i` on the box branch.

The modules run NCHW; `SCRFD` takes (B, H, W, 3) and returns NHWC head maps,
as the JAX module does, and the names are the flax ones, so `state_from_jax`
carries JAX weights across. Where the JAX module and mmdet differ, the port
follows JAX: nearest upsampling at half-pixel centres (nearest-exact) and
an avg-pool shortcut without ceil mode.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .image import detector_letterbox
from .detection import NUM_ANCHORS, SCRFD_STRIDES, detect_and_align


@dataclass(frozen=True)
class SCRFDConfig:
    stem_channels: int = 28              # first stem conv output (stem/2)
    stage_blocks: Tuple[int, ...] = (3, 5, 3, 3)
    stage_planes: Tuple[int, ...] = (56, 88, 88, 224)
    neck_out_channels: int = 56
    head_stacked_convs: int = 4
    head_feat_channels: int = 80
    num_anchors: int = NUM_ANCHORS
    strides: Tuple[int, ...] = SCRFD_STRIDES
    use_kps: bool = True
    norm: str = "bn"                     # "bn" (bnkps packs) or "gn"
    gn_groups: int = 16
    strides_share: bool = True           # one head tower for all strides
    cls_reg_share: bool = True           # reg branch reuses the cls tower


SCRFD_VARIANTS: Dict[str, SCRFDConfig] = {
    # buffalo_l's det_10g (scrfd_10g_bnkps)
    "scrfd_10g": SCRFDConfig(),
    # buffalo_s-class detector (scrfd_2.5g_bnkps)
    "scrfd_2.5g": SCRFDConfig(stem_channels=12,
                              stage_blocks=(3, 4, 2, 3),
                              stage_planes=(24, 48, 48, 80),
                              neck_out_channels=24,
                              head_stacked_convs=2,
                              head_feat_channels=64),
    "tiny": SCRFDConfig(stem_channels=4, stage_blocks=(1, 1, 1, 1),
                        stage_planes=(8, 8, 8, 16), neck_out_channels=8,
                        head_stacked_convs=1, head_feat_channels=8,
                        gn_groups=4),
}


def _norm(cfg: SCRFDConfig, channels: int) -> nn.Module:
    if cfg.norm == "gn":   # flax GroupNorm's default epsilon
        return nn.GroupNorm(cfg.gn_groups, channels, eps=1e-6)
    return nn.BatchNorm2d(channels, eps=1e-5)


def _conv(cin, cout, k, stride=1, padding=0, bias=True):
    return nn.Conv2d(cin, cout, k, stride, padding, bias=bias)


class BasicBlock(nn.Module):
    """ResNet BasicBlock with an avg-pool downsample shortcut (ResNetV1e)."""

    def __init__(self, in_planes: int, planes: int, stride: int,
                 cfg: SCRFDConfig):
        super().__init__()
        self.stride = stride
        self.conv1 = _conv(in_planes, planes, 3, stride, 1, bias=False)
        self.bn1 = _norm(cfg, planes)
        self.conv2 = _conv(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = _norm(cfg, planes)
        self.has_downsample = stride != 1 or in_planes != planes
        if self.has_downsample:
            self.downsample_conv = _conv(in_planes, planes, 1, bias=False)
            self.downsample_bn = _norm(cfg, planes)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        shortcut = x
        if self.has_downsample:
            if self.stride != 1:   # flax avg_pool: VALID, no ceil mode
                shortcut = F.avg_pool2d(shortcut, self.stride, self.stride)
            shortcut = self.downsample_bn(self.downsample_conv(shortcut))
        return F.relu(h + shortcut)


class SCRFDBackbone(nn.Module):
    def __init__(self, cfg: SCRFDConfig):
        super().__init__()
        self.cfg = cfg
        sc = cfg.stem_channels
        cin = 3
        for i, ch in enumerate((sc, sc, sc * 2)):
            self.add_module(f"stem_conv{i}", _conv(cin, ch, 3, 2 if i == 0
                                                   else 1, 1, bias=False))
            self.add_module(f"stem_bn{i}", _norm(cfg, ch))
            cin = ch
        for li, (n_blocks, planes) in enumerate(zip(cfg.stage_blocks,
                                                    cfg.stage_planes)):
            for bi in range(n_blocks):
                stride = 2 if (bi == 0 and li > 0) else 1
                self.add_module(f"layer{li + 1}_{bi}",
                                BasicBlock(cin, planes, stride, cfg))
                cin = planes

    def forward(self, x) -> Sequence[torch.Tensor]:
        h = x
        for i in range(3):
            h = getattr(self, f"stem_conv{i}")(h)
            h = F.relu(getattr(self, f"stem_bn{i}")(h))
        h = F.max_pool2d(h, 3, 2, 1)
        feats = []
        for li, n_blocks in enumerate(self.cfg.stage_blocks):
            for bi in range(n_blocks):
                h = getattr(self, f"layer{li + 1}_{bi}")(h)
            feats.append(h)
        return feats  # strides 4, 8, 16, 32


class PAFPN(nn.Module):
    """Path-aggregation FPN over the last three backbone stages."""

    def __init__(self, cfg: SCRFDConfig):
        super().__init__()
        out = cfg.neck_out_channels
        ins = cfg.stage_planes[1:]   # start_level=1 -> strides 8/16/32
        self.n = len(ins)
        for i, c in enumerate(ins):
            self.add_module(f"lateral_{i}", _conv(c, out, 1))
            self.add_module(f"fpn_{i}", _conv(out, out, 3, 1, 1))
        for i in range(self.n - 1):
            self.add_module(f"downsample_{i}", _conv(out, out, 3, 2, 1))
            self.add_module(f"pafpn_{i}", _conv(out, out, 3, 1, 1))

    def forward(self, feats: Sequence[torch.Tensor]):
        laterals = [getattr(self, f"lateral_{i}")(f)
                    for i, f in enumerate(feats[1:])]
        for i in range(self.n - 1, 0, -1):   # top-down
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                laterals[i], size=tuple(laterals[i - 1].shape[2:]),
                mode="nearest-exact")
        fpn = [getattr(self, f"fpn_{i}")(lat)
               for i, lat in enumerate(laterals)]
        outs = [fpn[0]]                       # bottom-up path aggregation
        for i in range(self.n - 1):
            down = getattr(self, f"downsample_{i}")(outs[-1])
            outs.append(getattr(self, f"pafpn_{i}")(down + fpn[i + 1]))
        return outs


class SCRFDHead(nn.Module):
    def __init__(self, cfg: SCRFDConfig):
        super().__init__()
        self.cfg = cfg
        a, f = cfg.num_anchors, cfg.head_feat_channels
        keys = ["0"] if cfg.strides_share else [str(s) for s in cfg.strides]
        towers = ("cls",) if cfg.cls_reg_share else ("cls", "reg")
        for key in keys:
            for prefix in towers:
                cin = cfg.neck_out_channels
                for j in range(cfg.head_stacked_convs):
                    # conv bias off where a norm follows (ConvModule)
                    self.add_module(f"{prefix}_convs_{key}_{j}",
                                    _conv(cin, f, 3, 1, 1, bias=False))
                    self.add_module(f"{prefix}_norm_{key}_{j}",
                                    _norm(cfg, f))
                    cin = f
            self.add_module(f"cls_pred_{key}", _conv(f, a, 3, 1, 1))
            self.add_module(f"reg_pred_{key}", _conv(f, a * 4, 3, 1, 1))
            if cfg.use_kps:
                self.add_module(f"kps_pred_{key}", _conv(f, a * 10, 3, 1, 1))
        for i in range(len(cfg.strides)):
            self.register_parameter(f"scale_{i}",
                                    nn.Parameter(torch.ones(())))

    def _tower(self, prefix: str, key: str, x):
        for j in range(self.cfg.head_stacked_convs):
            x = getattr(self, f"{prefix}_convs_{key}_{j}")(x)
            x = F.relu(getattr(self, f"{prefix}_norm_{key}_{j}")(x))
        return x

    def forward(self, feats: Sequence[torch.Tensor]):
        """NCHW maps per level -> {stride: {"scores", "bbox", "kps"}} NCHW."""
        c = self.cfg
        outputs = {}
        for i, (stride, feat) in enumerate(zip(c.strides, feats)):
            key = "0" if c.strides_share else str(stride)
            cls_feat = reg_feat = self._tower("cls", key, feat)
            if not c.cls_reg_share:
                reg_feat = self._tower("reg", key, feat)
            level = {
                "scores": getattr(self, f"cls_pred_{key}")(cls_feat),
                "bbox": getattr(self, f"scale_{i}")
                * getattr(self, f"reg_pred_{key}")(reg_feat)}
            if c.use_kps:
                level["kps"] = getattr(self, f"kps_pred_{key}")(reg_feat)
            outputs[stride] = level
        return outputs


class SCRFD(nn.Module):
    """(B, H, W, 3) image in detector normalization -> {stride: {scores
    (B, h, w, A), bbox (B, h, w, 4A), kps (B, h, w, 10A)}} raw head outputs
    (scores before the sigmoid), NHWC as the JAX module returns them."""

    def __init__(self, cfg: SCRFDConfig = SCRFDConfig()):
        super().__init__()
        self.cfg = cfg
        self.backbone = SCRFDBackbone(cfg)
        self.neck = PAFPN(cfg)
        self.head = SCRFDHead(cfg)

    def forward(self, x: torch.Tensor):
        raw = self.head(self.neck(self.backbone(x.permute(0, 3, 1, 2))))
        return {s: {k: v.permute(0, 2, 3, 1) for k, v in level.items()}
                for s, level in raw.items()}


def flatten_level_outputs(raw: Dict[int, Dict[str, torch.Tensor]],
                          batch_index: int = 0):
    """Raw NHWC head maps -> the {stride: (scores (N,), bbox (N, 4), kps
    (N, 10) or None)} layout `detect_and_align` takes, scores through the
    sigmoid; N = h*w*A, each anchor centre repeated A times."""
    out = {}
    for stride, level in raw.items():
        s = level["scores"][batch_index]
        h, w, a = s.shape
        bbox = level["bbox"][batch_index].reshape(h * w * a, 4)
        kps = None
        if "kps" in level:
            kps = level["kps"][batch_index].reshape(h * w * a, 10)
        out[stride] = (torch.sigmoid(s.reshape(-1)), bbox, kps)
    return out


def make_face_detector(state: Mapping[str, torch.Tensor],
                       cfg: Optional[SCRFDConfig] = None,
                       input_size: int = 640, score_thresh: float = 0.5,
                       device: Union[str, torch.device] = "cuda"):
    """(H, W, 3) uint8 image -> (aligned (112, 112, 3) fp32 RGB in [0, 255],
    score, box): the reference's FaceAnalysis.get() (JAX
    make_face_detector). Letterbox to the detector input (640 for SD1.5),
    SCRFD forward, decode, fixed-shape NMS and Umeyama alignment; the model
    runs in fp32 on `device`. The keypoints are found in the letterboxed
    image, and the aligned crop is taken from it, so the similarity
    transform absorbs the resize scale; only the box is scaled back."""
    device = torch.device(device)
    cfg = cfg or SCRFDConfig()
    with torch.device("meta"):
        model = SCRFD(cfg)
    model.load_state_dict(state, assign=True)
    model = model.to(device=device, dtype=torch.float32).eval()

    @torch.no_grad()
    def detect(image: np.ndarray):
        x, scale = detector_letterbox(image, input_size)
        x = torch.from_numpy(x).to(device)
        levels = flatten_level_outputs(model(x))
        aligned, score, box = detect_and_align(
            levels, x[0], (input_size, input_size), score_thresh=score_thresh)
        return ((aligned * 128.0 + 127.5).cpu().numpy(), float(score),
                (box / scale).cpu().numpy())

    detect.model = model
    detect.input_size = input_size
    return detect
