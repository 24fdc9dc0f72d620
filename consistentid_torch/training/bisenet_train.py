"""BiSeNet face-parsing training, on one device or data-parallel with
SyncBN: the port's counterpart of the JAX package's
training/bisenet_train.py (the reference's models/BiSeNet/train.py: OHEM
cross-entropy at three scales, exponential warm-up then poly SGD).

The reference's hyperparameters: batch 16 per device, crop 448, 19 classes,
OHEM threshold 0.7 with n_min = B*H*W/16, SGD momentum 0.9, weight decay
5e-4 on the convolution kernels only, 10x the learning rate on the fusion
module and the three output heads, lr 1e-2, 80k iterations, power 0.9, a
1k-step warm-up from 1e-5.

Semantics held to JAX's (optax and flax):
  - `BiSeNetSGD` is optax's `multi_transform` of four
    `chain(add_decayed_weights, sgd(schedule, momentum))` groups: weight
    decay added to the gradient before the momentum trace t = g + 0.9 t,
    the update -lr(count) t, count starting at 0 and counted per group. The
    10x group's schedule is `warmup_poly_schedule(lr0=10 lr0)` with the
    same warm-up start 1e-5, so both groups start at 1e-5 and the 10x one
    warms up along a steeper curve (not 10x the base group's rate);
  - the schedule is evaluated in fp32, as JAX's;
  - BatchNorm runs flax's train statistics (models/bisenet.py): with a
    mesh the statistics are averaged over the data group (with their
    gradient), the gradients and the loss over the same group before SGD;
  - OHEM: ignored pixels (255) keep a zero loss but count in n_pix and in
    the top-n_min mean; `ce_sorted[n_min]` is the 0-based n_min-th
    largest.
No CLI: the JAX package has none. `FaceMaskDataset` reads the
CelebAMask-HQ layout (image dir + grey label dir) without PIL.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.bisenet import BiSeNet, set_sync_group
from ..parallel.mesh import all_reduce_mean, data_axis_size

IGNORE_LABEL = 255
LR_MUL_MODULES = ("ffm", "conv_out", "conv_out16", "conv_out32")


def ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                       thresh: float = 0.7,
                       n_min: Optional[int] = None) -> torch.Tensor:
    """Online hard-example mining CE (reference loss.py OhemCELoss) on
    NCHW logits and (B, H, W) labels: the mean of the pixel losses above
    -log(thresh) when the n_min-th largest is above it, else the mean of
    the n_min largest. In fp32 (fp64 logits stay fp64)."""
    b, c, h, w = logits.shape
    n_pix = b * h * w
    if n_min is None:
        n_min = n_pix // 16
    labels = labels.long()
    valid = labels != IGNORE_LABEL
    ce = F.cross_entropy(
        logits.to(torch.promote_types(logits.dtype, torch.float32)),
        torch.where(valid, labels, 0), reduction="none")
    ce = torch.where(valid, ce, 0.0).reshape(-1)
    thresh_val = -float(np.log(np.float32(thresh)))
    top = torch.topk(ce, n_min + 1).values
    above = ce > thresh_val
    thresh_mean = torch.where(above, ce, 0.0).sum() / above.sum().clamp_min(1)
    topk_mean = top[:n_min].mean()
    return torch.where(top[n_min] > thresh_val, thresh_mean, topk_mean)


def warmup_poly_schedule(lr0: float = 1e-2, warmup_steps: int = 1000,
                         warmup_start_lr: float = 1e-5,
                         max_iter: int = 80000, power: float = 0.9):
    """step -> learning rate: exponential warm-up from warmup_start_lr to
    lr0 over warmup_steps, then (1 - progress)^power decay to 0
    (reference optimizer.py), in fp32 as the JAX schedule."""
    f32 = np.float32
    factor = f32((lr0 / warmup_start_lr) ** (1.0 / warmup_steps))

    def schedule(step: int) -> float:
        s = f32(step)
        if s <= warmup_steps:
            return float(f32(warmup_start_lr) * factor ** s)
        progress = (s - f32(warmup_steps)) / f32(max_iter - warmup_steps)
        poly = f32(lr0) * (f32(1.0) - progress) ** f32(power)
        return float(max(poly, f32(0.0)))

    return schedule


def param_group(name: str, param: torch.Tensor) -> str:
    """JAX `_param_group`: "mul" for the fusion module and the output
    heads, "base" else; "wd" for the convolution kernels, "nowd" for the
    BatchNorm scales and biases."""
    mul = name.split(".")[0] in LR_MUL_MODULES
    wd = param.dim() > 1
    return f"{'mul' if mul else 'base'}_{'wd' if wd else 'nowd'}"


class BiSeNetSGD:
    """optax's four-group SGD of the JAX package's
    `make_bisenet_optimizer` (module docstring). `trace` holds each
    parameter's momentum, `count` each group's update count."""

    GROUPS = ("base_wd", "base_nowd", "mul_wd", "mul_nowd")

    def __init__(self, named_params: Mapping[str, torch.Tensor],
                 lr0: float = 1e-2, momentum: float = 0.9,
                 weight_decay: float = 5e-4, lr_mul: float = 10.0,
                 **sched_kw):
        self.params = dict(named_params)
        self.groups = {n: param_group(n, p) for n, p in self.params.items()}
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.schedules = {
            "base": warmup_poly_schedule(lr0=lr0, **sched_kw),
            "mul": warmup_poly_schedule(lr0=lr0 * lr_mul, **sched_kw)}
        self.trace = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.count = {g: 0 for g in self.GROUPS}

    def learning_rate(self, group: str) -> float:
        return self.schedules[group.split("_")[0]](self.count[group])

    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor]) -> None:
        lrs = {g: self.learning_rate(g) for g in self.GROUPS}
        for name, p in self.params.items():
            group = self.groups[name]
            g = grads[name]
            if group.endswith("_wd") and self.weight_decay:
                g = g + self.weight_decay * p
            t = g + self.momentum * self.trace[name]
            self.trace[name] = t
            p.add_(t * (-lrs[group]))
        for g in self.GROUPS:
            self.count[g] += 1


@dataclass
class BiSeNetTrainState:
    """The model (parameters and BatchNorm running statistics), the
    optimizer (momentum traces and counts) and the step."""
    model: BiSeNet
    optimizer: BiSeNetSGD
    step: int = 0


@torch.no_grad()
def init_bisenet(model: BiSeNet, generator: torch.Generator) -> None:
    """flax's default initialisers: LeCun-normal convolution kernels
    (truncated at 2 sigma), unit BatchNorm scales, zero biases and running
    means, unit running variances."""
    for name, p in model.named_parameters():
        if p.dim() > 1:
            std = p[0].numel() ** -0.5 / 0.87962566103423978
            p.copy_(torch.nn.init.trunc_normal_(
                torch.empty(p.shape), std=std, a=-2 * std, b=2 * std,
                generator=generator))
        elif name.endswith("weight"):
            p.fill_(1.0)
        else:
            p.zero_()
    for name, b in model.named_buffers():
        if name.endswith("running_var"):
            b.fill_(1.0)
        elif name.endswith("running_mean"):
            b.zero_()


def create_bisenet_train_state(n_classes: int = 19, seed: int = 0,
                               device="cuda",
                               state: Optional[Mapping] = None,
                               **opt_kw) -> BiSeNetTrainState:
    """A fresh fp32 BiSeNet in train mode with its optimizer, on `device`:
    initialised from `seed`, or from `state`, a carried JAX train state
    (`io.from_jax.bisenet_train_state_from_jax`: the model's state dict,
    the momentum traces, the counts and the step)."""
    model = BiSeNet(n_classes)
    if state is None:
        init_bisenet(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state["model"])
    model = model.to(device=device, dtype=torch.float32).train()
    optimizer = BiSeNetSGD(dict(model.named_parameters()), **opt_kw)
    step = 0
    if state is not None:
        for name, t in state["momentum"].items():
            optimizer.trace[name] = t.to(device=device, dtype=torch.float32)
        optimizer.count.update(state["count"])
        step = int(state["step"])
    return BiSeNetTrainState(model, optimizer, step)


def make_bisenet_train_step(mesh=None, ohem_thresh: float = 0.7,
                            ohem_shards: int = 1):
    """step(state, images (B, H, W, 3) fp32 NHWC, labels (B, H, W) int)
    -> (state, {"loss"}): the three OHEM losses summed, their gradient,
    SGD; the model is updated in place. With a mesh of a data axis above
    1 each rank passes its shard, BatchNorm is synced over the data group
    and gradients and loss are averaged over it (JAX's shard_map step).
    `ohem_shards` = n on one device replays an n-rank step over the whole
    batch: the loss is the mean of the OHEM losses of n equal shards (OHEM
    keeps its n_min and threshold mean per rank), BatchNorm over all."""
    group = mesh.data_group if data_axis_size(mesh) > 1 else None

    def loss_of(o, labels):
        return sum(ohem_cross_entropy(a, b, ohem_thresh) for a, b in zip(
            o.chunk(ohem_shards), labels.chunk(ohem_shards))) / ohem_shards

    def step(state: BiSeNetTrainState, images, labels
             ) -> Tuple[BiSeNetTrainState, Dict[str, torch.Tensor]]:
        model = state.model
        first = next(model.parameters())
        images = torch.as_tensor(images, device=first.device,
                                 dtype=first.dtype)
        labels = torch.as_tensor(labels, device=first.device)
        model.train()
        set_sync_group(model, group)
        outs = model.forward_nchw(images.permute(0, 3, 1, 2))
        loss = sum(loss_of(o, labels) for o in outs)
        names = list(state.optimizer.params)
        grads = torch.autograd.grad(loss, [state.optimizer.params[n]
                                           for n in names])
        loss = loss.detach()
        if group is not None:
            grads = all_reduce_mean(list(grads), group)
            loss = all_reduce_mean([loss], group)[0]
        state.optimizer.step(dict(zip(names, grads)))
        state.step += 1
        return state, {"loss": loss}

    return step


# ------------------------------------------------------------------ data

def read_face_image(path: str) -> np.ndarray:
    """An image file as uint8 (H, W, 3), by its content: PNG through
    utils/png.py (a PNG under a .jpg name too), JPEG through the native
    loader where it builds (decoded at 512 x 512, the dataset's first
    resize, with its half-pixel bilinear), else refused with the reason."""
    from ..utils.png import as_rgb, decode_png

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return as_rgb(decode_png(data))
    if data[:2] == b"\xff\xd8":
        from ..io import native_loader
        img = native_loader.decode_resize_normalize(path, 512, 512)
        if img is None:
            raise ValueError(f"{path}: a JPEG, and no JPEG decoder here: "
                             f"{native_loader.route()}")
        return np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)
    raise ValueError(f"{path}: neither PNG nor JPEG")


class FaceMaskDataset:
    """CelebAMask-HQ-style data (an image dir, `name.jpg`, and a grey
    label dir, `name.png`) with the reference's augmentations (JAX
    `FaceMaskDataset`; face_dataset.py/transform.py): resize to 512
    (BILINEAR, labels NEAREST, PIL's bit for bit), a random horizontal
    flip, a random scale of SCALES, padding up to the crop (labels with
    255), a random crop; ImageNet normalisation. The draws come from one
    `np.random.RandomState(seed)` in JAX's order."""

    SCALES = (0.75, 1.0, 1.25, 1.5, 1.75, 2.0)

    def __init__(self, image_root: str, label_root: str, crop: int = 448,
                 seed: int = 0):
        self.image_root = image_root
        self.label_root = label_root
        self.crop = crop
        self.names = sorted(
            os.path.splitext(f)[0] for f in os.listdir(image_root))
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, i: int):
        from ..utils.image import (IMAGENET_MEAN, IMAGENET_STD,
                                   resize_bilinear_uint8,
                                   resize_nearest_uint8)
        from ..utils.png import read_array

        name = self.names[i]
        img = read_face_image(os.path.join(self.image_root, name + ".jpg"))
        lab = read_array(os.path.join(self.label_root, name + ".png"))
        if lab.ndim == 3 and lab.shape[2] == 1:
            lab = lab[:, :, 0]
        if lab.ndim != 2:
            raise ValueError(f"{name}.png: a label map is grey, not "
                             f"{lab.shape}")
        img = resize_bilinear_uint8(img, 512, 512)
        lab = resize_nearest_uint8(lab, 512, 512)
        if self.rng.rand() < 0.5:
            img, lab = img[:, ::-1], lab[:, ::-1]
        scale = self.SCALES[self.rng.randint(len(self.SCALES))]
        w = h = int(512 * scale)
        img = resize_bilinear_uint8(np.ascontiguousarray(img), h, w)
        lab = resize_nearest_uint8(lab, h, w)
        if w < self.crop:
            pad = self.crop - w
            img = np.pad(img, ((0, pad), (0, pad), (0, 0)))
            lab = np.pad(lab, ((0, pad), (0, pad)),
                         constant_values=IGNORE_LABEL)
            w = h = self.crop
        x0 = self.rng.randint(w - self.crop + 1)
        y0 = self.rng.randint(h - self.crop + 1)
        img = np.asarray(img, np.float32)[y0:y0 + self.crop,
                                          x0:x0 + self.crop] / 255.0
        lab = lab[y0:y0 + self.crop, x0:x0 + self.crop]
        img = (img - IMAGENET_MEAN) / IMAGENET_STD
        return img.astype(np.float32), lab.astype(np.int32)

    def batches(self, batch_size: int, epochs: int = 1):
        order = list(range(len(self)))
        for _ in range(epochs):
            self.rng.shuffle(order)
            for s in range(0, len(order) - batch_size + 1, batch_size):
                items = [self[j] for j in order[s:s + batch_size]]
                yield (np.stack([x for x, _ in items]),
                       np.stack([y for _, y in items]))
