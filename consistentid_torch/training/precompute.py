"""Precomputed frozen-encoder conditioning, the counterpart of the JAX
package's training/precompute.py.

The SD1.5 train step runs frozen encoders every step: the VAE encode of the
target image, ViT-H over the face and its region crops, CLIP-text over the
caption. None of it depends on the trainable adapters, so it is constant
over the corpus: `precompute_conditioning` runs those encoders once over an
FGIDDataset and `consistentid_loss_encoded` trains from the cached tensors.

The VAE posterior moments (mean, logvar) are cached, not a sample: the
encoded loss samples the posterior each step as AutoencoderKL.encode does.
CFG dropout (reference utils.py:111-118) moves into EncodedFGIDDataset:
its text-drop and text-and-image-drop branches swap in cached
null-conditioning tensors (the empty caption's text embeddings, the zero
image's ViT features), the tensors the pixel path would have produced.

Storage: bf16 tensors as their bit patterns in uint16 (exact, half the fp32
bytes), fp32 tensors as they are; binary masks as uint8. One .npz per
sample beside shared.npz and encoded_manifest.json, the JAX package's
layout, so either package reads the other's cache.

`synthetic_encoded_batch` makes a batch of the encoded schema from a seed,
with the JAX package's draws.
"""
from __future__ import annotations

import json
import os
import random
from typing import Dict, Optional

import numpy as np
import torch

from ..conditioning import (prepare_trigger_token_idx,
                            tokenize_and_mask_trigger_ends)
from .dataset import FGIDDataset

_BF16_KEYS = ("latent_mean", "latent_logvar", "face_embeds",
              "region_embeds", "prompt_embeds")
_MASK_KEYS = ("region_masks", "bg_masks")
FORMAT = "consistentid-encoded-v1"


def pack_float(x) -> np.ndarray:
    """An encoder output as a storage array, exact for its dtype: bf16 as
    its uint16 bit patterns, anything else as fp32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.float().numpy()
    return np.asarray(x, np.float32)


def unpack_float(u: np.ndarray) -> np.ndarray:
    """Inverse of pack_float, as fp32 (bf16 values are a subset of it)."""
    if u.dtype == np.uint16:
        return (u.astype(np.uint32) << 16).view(np.float32)
    return np.asarray(u, np.float32)


@torch.no_grad()
def _encode(bundle, images, face_pixels, region_pixels, clean_ids):
    """The frozen encoders on one batch, on the bundle's device: VAE
    moments, ViT-H penultimate states of the face and its regions, CLIP-text
    states."""
    dev = bundle.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    mean, logvar = bundle.vae.encode_moments(t(images))
    b, s = images.shape[0], bundle.vision_config.image_size
    vit_in = torch.cat([t(face_pixels),
                        t(region_pixels).reshape(-1, s, s, 3)])
    _, penult = bundle.image_encoder(vit_in)
    regions = penult[b:].reshape(b, region_pixels.shape[1],
                                 *penult.shape[1:])
    prompt, _ = bundle.text_encoder(t(clean_ids).long())
    return mean, logvar, penult[:b], regions, prompt


def precompute_conditioning(bundle, dataset: FGIDDataset, out_dir: str,
                            batch_size: int = 8,
                            progress: bool = True) -> str:
    """Run the bundle's frozen encoders over `dataset` once, on its device;
    write one .npz per sample plus the shared null-conditioning tensors and
    a manifest. Returns the manifest's path (for EncodedFGIDDataset)."""
    os.makedirs(os.path.join(out_dir, "enc"), exist_ok=True)
    # the cached content has no dropout: it is applied at train time from
    # the null tensors
    saved = (dataset.text_drop_prob, dataset.image_drop_prob)
    dataset.text_drop_prob = dataset.image_drop_prob = 0.0
    try:
        samples = []
        n = len(dataset)
        for start in range(0, n, batch_size):
            idxs = list(range(start, min(start + batch_size, n)))
            examples = [dataset[i] for i in idxs]
            stacked = {k: np.stack([e[k] for e in examples])
                       for k in examples[0]}
            encoded = _encode(bundle, stacked["images"],
                              stacked["face_pixels"],
                              stacked["region_pixels"], stacked["clean_ids"])
            mean, logvar, face, regions, prompt = (
                pack_float(x) for x in encoded)
            for j, (i, ex) in enumerate(zip(idxs, examples)):
                rel = os.path.join("enc", f"{i:08d}.npz")
                np.savez_compressed(
                    os.path.join(out_dir, rel),
                    latent_mean=mean[j], latent_logvar=logvar[j],
                    face_embeds=face[j], region_embeds=regions[j],
                    prompt_embeds=prompt[j],
                    faceid_embeds=ex["faceid_embeds"].astype(np.float32),
                    facial_idx=ex["facial_idx"].astype(np.int32),
                    facial_idx_mask=ex["facial_idx_mask"].astype(bool),
                    region_masks=(ex["region_masks"] > 0.5).astype(np.uint8),
                    bg_masks=(ex["bg_masks"] > 0.5).astype(np.uint8))
                samples.append(rel)
            if progress:
                print(f"precompute {min(start + batch_size, n)}/{n}",
                      flush=True)

        # the shared null conditioning: the empty caption and the zero
        # image, the tensors the pixel path produces when the CFG dropout
        # branches fire (reference utils.py:111-118)
        null_ids, img_mask, fac_mask = tokenize_and_mask_trigger_ends(
            "", None, dataset.facial_token_id, dataset.tokenizer)
        _, _, null_idx, null_idx_mask = prepare_trigger_token_idx(
            img_mask, fac_mask, 1, dataset.max_num_facials)
        first = dataset[0]
        zero_img = np.zeros((1, dataset.clip_size, dataset.clip_size, 3),
                            np.float32)
        _, _, null_face, _, null_prompt = _encode(
            bundle, first["images"][None], zero_img,
            first["region_pixels"][None],
            null_ids[:1].astype(np.int32))
        np.savez_compressed(
            os.path.join(out_dir, "shared.npz"),
            null_face_embeds=pack_float(null_face[0]),
            null_prompt_embeds=pack_float(null_prompt[0]),
            null_facial_idx=np.asarray(null_idx[0], np.int32),
            null_facial_idx_mask=np.asarray(null_idx_mask[0], bool))
    finally:
        dataset.text_drop_prob, dataset.image_drop_prob = saved

    manifest = {"format": FORMAT, "samples": samples, "shared": "shared.npz"}
    path = os.path.join(out_dir, "encoded_manifest.json")
    with open(path, "w") as f:
        json.dump(manifest, f)
    return path


class EncodedFGIDDataset(FGIDDataset):
    """FGIDDataset over a precomputed directory: the same batches() (worker
    threads included), emitting the consistentid_loss_encoded schema. CFG
    dropout takes the pixel dataset's branches in the same order of draws
    (10% text only, the next 10% text and image, reference
    utils.py:111-118), from the cached null tensors."""

    def __init__(self, manifest_path: str, text_drop_prob: float = 0.1,
                 image_drop_prob: float = 0.1, seed: int = 0):
        with open(manifest_path) as f:
            m = json.load(f)
        if m.get("format") != FORMAT:
            raise ValueError(f"{manifest_path} is not an encoded manifest")
        self.root = os.path.dirname(os.path.abspath(manifest_path))
        self.items = m["samples"]
        self.text_drop_prob = text_drop_prob
        self.image_drop_prob = image_drop_prob
        self.rng = random.Random(seed)
        with np.load(os.path.join(self.root, m["shared"])) as sh:
            self.null_face = unpack_float(sh["null_face_embeds"])
            self.null_prompt = unpack_float(sh["null_prompt_embeds"])
            self.null_idx = sh["null_facial_idx"]
            self.null_idx_mask = sh["null_facial_idx_mask"]

    def _load_item(self, i: int) -> Dict[str, np.ndarray]:
        with np.load(os.path.join(self.root, self.items[i])) as z:
            ex = {k: (unpack_float(z[k]) if k in _BF16_KEYS
                      else np.asarray(z[k])) for k in z.files}
        for k in _MASK_KEYS:
            ex[k] = ex[k].astype(np.float32)

        p = self.rng.random()
        if p < self.text_drop_prob * 2:       # text dropped either way
            ex["prompt_embeds"] = self.null_prompt
            ex["facial_idx"] = self.null_idx
            ex["facial_idx_mask"] = self.null_idx_mask
            if p >= self.text_drop_prob:      # second branch: image too
                ex["face_embeds"] = self.null_face
        return ex


def synthetic_encoded_batch(bundle, batch_size: int = 2,
                            latent_hw: int = 64, seed: int = 0,
                            max_num_facials: int = 5,
                            mask_hw: Optional[int] = None
                            ) -> Dict[str, np.ndarray]:
    """Random batch with the consistentid_loss_encoded schema at the
    bundle's real shapes."""
    rng = np.random.RandomState(seed)
    v = bundle.vision_config
    t = bundle.text_config
    a = bundle.adapter_config
    n_tok = (v.image_size // v.patch_size) ** 2 + 1
    mask_hw = mask_hw or latent_hw * 8
    lat_c = bundle.vae_config.latent_channels
    f32 = lambda *s: rng.randn(*s).astype(np.float32) * 0.5  # noqa: E731
    idx = np.tile(np.array([[3, 7, 11, 0, 0]], np.int32)
                  [:, :max_num_facials], (batch_size, 1))
    return {
        "latent_mean": f32(batch_size, latent_hw, latent_hw, lat_c),
        "latent_logvar": f32(batch_size, latent_hw, latent_hw, lat_c),
        "face_embeds": f32(batch_size, n_tok, v.hidden_size),
        "region_embeds": f32(batch_size, max_num_facials, n_tok,
                             v.hidden_size),
        "prompt_embeds": f32(batch_size, t.max_position_embeddings,
                             t.hidden_size),
        "faceid_embeds": f32(batch_size, a.id_embeddings_dim),
        "facial_idx": idx,
        "facial_idx_mask": np.tile(
            np.array([[True, True, True, False, False]]
                     [0][:max_num_facials]), (batch_size, 1)),
        "region_masks": (rng.rand(batch_size, max_num_facials, mask_hw,
                                  mask_hw) > 0.5).astype(np.float32),
        "bg_masks": np.ones((batch_size, mask_hw, mask_hw), np.float32),
    }
