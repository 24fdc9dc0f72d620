"""Face-detection post-processing and alignment, counterpart of the JAX
package's models/detection.py, with its fixed shapes:
  - `decode_level`: distance-to-box and keypoint decode on dense anchor
    centres (2 anchors per position, strides 8/16/32, the SCRFD layout);
  - `topk_nms`: the top-K candidates by score, then greedy IoU suppression;
  - `estimate_similarity` / `align_face`: the Umeyama similarity transform
    to the ArcFace template and a bilinear inverse warp.

The greedy suppression is a loop of K = 128 dependent steps (slot i is kept
unless a kept slot before it overlaps it). On the card each step would be a
few launches of tiny kernels; here the (K, K) IoU matrix and the candidate
mask make one round trip to the host, where the loop runs in numpy on the
same fp32 values, and the keep mask goes back: one synchronisation instead of
hundreds of launches, and JAX's mask bit for bit (ties included: scores tie
by index, IoUs at the threshold are not suppressed).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

SCRFD_STRIDES = (8, 16, 32)
NUM_ANCHORS = 2

# ArcFace 112x112 5-point destination template (insightface convention):
# left eye, right eye, nose, left mouth corner, right mouth corner
ARCFACE_DST = np.array([
    [38.2946, 51.6963],
    [73.5318, 51.5014],
    [56.0252, 71.7366],
    [41.5493, 92.3655],
    [70.7299, 92.2041],
], np.float32)


def anchor_centers(height: int, width: int, stride: int,
                   num_anchors: int = NUM_ANCHORS,
                   device: Optional[torch.device] = None) -> torch.Tensor:
    """(H*W*A, 2) anchor centre xy coordinates of one stride level."""
    ys = torch.arange(height, dtype=torch.float32, device=device) * stride
    xs = torch.arange(width, dtype=torch.float32, device=device) * stride
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    centers = torch.stack([gx, gy], dim=-1).reshape(-1, 2)
    return centers.repeat_interleave(num_anchors, dim=0)


def decode_level(scores: torch.Tensor, bbox_deltas: torch.Tensor,
                 kps_deltas: Optional[torch.Tensor], stride: int,
                 height: int, width: int):
    """Decode one stride level: scores (N,), bbox_deltas (N, 4) distances
    l/t/r/b in stride units, kps_deltas (N, 10) or None; N = H*W*A.
    Returns (scores (N,), boxes (N, 4) xyxy, kps (N, 5, 2) or None)."""
    centers = anchor_centers(height, width, stride, device=scores.device)
    d = bbox_deltas * stride
    boxes = torch.stack([
        centers[:, 0] - d[:, 0], centers[:, 1] - d[:, 1],
        centers[:, 0] + d[:, 2], centers[:, 1] + d[:, 3]], dim=-1)
    kps = None
    if kps_deltas is not None:
        kps = centers[:, None, :] + kps_deltas.reshape(-1, 5, 2) * stride
    return scores, boxes, kps


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(K, K) pairwise IoU."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    ix1 = torch.maximum(x1[:, None], x1[None, :])
    iy1 = torch.maximum(y1[:, None], y1[None, :])
    ix2 = torch.minimum(x2[:, None], x2[None, :])
    iy2 = torch.minimum(y2[:, None], y2[None, :])
    inter = (ix2 - ix1).clamp_min(0) * (iy2 - iy1).clamp_min(0)
    union = area[:, None] + area[None, :] - inter
    return inter / union.clamp_min(1e-9)


def greedy_keep(iou: np.ndarray, candidate: np.ndarray,
                iou_thresh: float) -> np.ndarray:
    """Slot i survives iff it is a candidate and no kept slot before it
    overlaps it by more than `iou_thresh` (JAX's fori_loop body)."""
    over = iou > np.float32(iou_thresh)
    keep = np.zeros(len(candidate), bool)
    for i in range(len(candidate)):
        keep[i] = candidate[i] and not (keep[:i] & over[i, :i]).any()
    return keep


def topk_nms(scores: torch.Tensor, boxes: torch.Tensor,
             kps: Optional[torch.Tensor] = None, *, top_k: int = 128,
             score_thresh: float = 0.5, iou_thresh: float = 0.4):
    """Fixed-shape NMS: the top-K slots by score (equal scores in index
    order, as jax.lax.top_k), greedy suppression over their IoU matrix.
    Returns (scores (K,), boxes (K, 4), kps (K, 5, 2) or None, keep (K,)
    bool), where suppressed and below-threshold slots are not kept."""
    order = torch.sort(scores, descending=True, stable=True).indices[:top_k]
    k_scores, k_boxes = scores[order], boxes[order]
    k_kps = kps[order] if kps is not None else None
    iou = _iou_matrix(k_boxes)
    candidate = k_scores >= score_thresh
    keep = greedy_keep(iou.cpu().numpy(), candidate.cpu().numpy(),
                       iou_thresh)
    return k_scores, k_boxes, k_kps, torch.from_numpy(keep).to(scores.device)


def estimate_similarity(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Umeyama similarity transform (rotation, scale, translation) mapping
    src (N, 2) to dst (N, 2); returns the (2, 3) affine matrix. The rotation
    u diag(1, d) vt does not depend on the signs the SVD picks."""
    src, dst = src.float(), dst.float()
    src_mean, dst_mean = src.mean(0), dst.mean(0)
    src_c, dst_c = src - src_mean, dst - dst_mean
    cov = dst_c.T @ src_c / src.shape[0]
    u, s, vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(u) * torch.linalg.det(vt))
    diag = torch.stack([torch.ones_like(d), d])
    rot = u @ torch.diag(diag) @ vt
    var_src = (src_c ** 2).sum() / src.shape[0]
    scale = (s * diag).sum() / var_src.clamp_min(1e-9)
    t = dst_mean - scale * (rot @ src_mean)
    return torch.cat([scale * rot, t[:, None]], dim=1)


def warp_affine(image: torch.Tensor, matrix: torch.Tensor, out_h: int,
                out_w: int) -> torch.Tensor:
    """Bilinear inverse warp of (H, W, C) by a (2, 3) forward affine; pixels
    that map outside the image are 0."""
    dev = image.device
    full = torch.cat([matrix, torch.tensor([[0.0, 0.0, 1.0]], device=dev)])
    inv = torch.linalg.inv(full)[:2]
    ys, xs = torch.meshgrid(torch.arange(out_h, dtype=torch.float32,
                                         device=dev),
                            torch.arange(out_w, dtype=torch.float32,
                                         device=dev), indexing="ij")
    coords = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
    src = coords @ inv.T
    sx, sy = src[..., 0], src[..., 1]
    h, w = image.shape[:2]
    x0 = torch.floor(sx).long().clamp(0, w - 1)
    y0 = torch.floor(sy).long().clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    wx = (sx - x0).clamp(0.0, 1.0)[..., None]
    wy = (sy - y0).clamp(0.0, 1.0)[..., None]
    img = image.float()
    top = img[y0, x0] * (1 - wx) + img[y0, x1] * wx
    bot = img[y1, x0] * (1 - wx) + img[y1, x1] * wx
    out = top * (1 - wy) + bot * wy
    inside = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    return torch.where(inside[..., None], out, torch.zeros_like(out))


def align_face(image: torch.Tensor, keypoints: torch.Tensor,
               size: int = 112) -> torch.Tensor:
    """5-point similarity alignment to the ArcFace template."""
    dst = torch.from_numpy(ARCFACE_DST * (size / 112.0)).to(image.device)
    return warp_affine(image, estimate_similarity(keypoints, dst), size, size)


def select_face(
    level_outputs: Dict[int, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    input_size: Tuple[int, int],
    top_k: int = 128,
    score_thresh: float = 0.5,
    iou_thresh: float = 0.4,
):
    """Decode every stride level and NMS; returns (best slot, top-K scores,
    boxes, keypoints). As in JAX, when no slot is kept the argmax over all
    -inf picks slot 0, the highest score, below the threshold."""
    all_scores, all_boxes, all_kps = [], [], []
    for stride, (s, b, k) in level_outputs.items():
        h, w = input_size[0] // stride, input_size[1] // stride
        sc, bx, kp = decode_level(s, b, k, stride, h, w)
        all_scores.append(sc)
        all_boxes.append(bx)
        all_kps.append(kp)
    k_scores, k_boxes, k_kps, keep = topk_nms(
        torch.cat(all_scores), torch.cat(all_boxes), torch.cat(all_kps),
        top_k=top_k, score_thresh=score_thresh, iou_thresh=iou_thresh)
    masked = torch.where(keep, k_scores,
                         torch.full_like(k_scores, -float("inf")))
    return torch.argmax(masked), k_scores, k_boxes, k_kps


def detect_and_align(
    level_outputs: Dict[int, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    image: torch.Tensor,
    input_size: Tuple[int, int],
    top_k: int = 128,
    score_thresh: float = 0.5,
    iou_thresh: float = 0.4,
):
    """Decode, NMS and align the best-scoring kept face (`select_face`).
    level_outputs: {stride: (scores, bbox_deltas, kps_deltas)} raw head
    outputs at `input_size`. Returns (aligned (112, 112, C), best score,
    best box)."""
    best, k_scores, k_boxes, k_kps = select_face(
        level_outputs, input_size, top_k, score_thresh, iou_thresh)
    return align_face(image, k_kps[best]), k_scores[best], k_boxes[best]
