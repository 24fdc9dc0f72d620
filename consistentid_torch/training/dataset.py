"""FGID training data on the host (numpy), the counterpart of the JAX
package's training/dataset.py.

Mirrors the reference MyDataset/collate_fn (utils.py:12-218): a JSON
manifest of {image, parsing map, FaceID embedding, captions}; per item the
marker-processed caption, the trigger-token index arrays, per-region CLIP
crops, localization segmaps and the WithoutBackground mask, all padded to
max_num_facials so every batch has one shape.

Images are numpy arrays, never PIL: a file is read through `decode` (bytes
-> uint8 (H, W[, C])), by default the port's PNG decoder (utils/png.py), so
the machine with the card needs neither Pillow nor OpenCV; a caller brings
a JPEG decoder the same way. A `.npy` file is loaded as the array it holds.
The image is taken as RGB, the parsing map as 8-bit grey.

`synthetic_batch` makes a batch of the same schema from a seed, with the
JAX package's draws (tests, smoke runs).
"""
from __future__ import annotations

import json
import logging
import os
import random
from typing import Callable, Dict, Optional

import numpy as np

from ..conditioning import (fetch_mask_raw_image, masks_for_unique_values,
                            prepare_trigger_token_idx,
                            process_text_with_markers,
                            tokenize_and_mask_trigger_ends)
from ..pipelines.consistentid_sd15 import select_key_regions
from ..utils.image import (center_crop_mask, clip_preprocess,
                           sd_image_preprocess)
from ..utils.png import as_rgb, decode_png

Decoder = Callable[[bytes], np.ndarray]


def read_array(path: str, decode: Decoder = decode_png) -> np.ndarray:
    """An image file as a uint8 array: `.npy` loaded, anything else
    decoded from its bytes."""
    if path.endswith(".npy"):
        return np.load(path)
    with open(path, "rb") as f:
        return decode(f.read())


def as_grey(image: np.ndarray) -> np.ndarray:
    """A uint8 (H, W) label map from (H, W) or (H, W, 1)."""
    arr = np.asarray(image)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    if arr.ndim != 2:
        raise ValueError(f"a parsing map must be 8-bit grey, got shape "
                         f"{arr.shape}")
    return arr


class FGIDDataset:
    """Iterates manifest entries into fixed-shape numpy training examples.

    Manifest entry schema (reference README.md:98-110 / utils.py:24-47):
      {"image_path": ..., "parsing_mask_path": ..., "faceid_path": ...,
       "vqa_llva": caption, "vqa_llva_more_face_detail": facial caption}
    """

    def __init__(self, manifest_path: str, tokenizer, size: int = 512,
                 clip_size: int = 224, image_root: str = "",
                 max_num_facials: int = 5, text_drop_prob: float = 0.1,
                 image_drop_prob: float = 0.1, seed: int = 0,
                 id_dim: int = 512, decode: Decoder = decode_png):
        with open(manifest_path) as f:
            data = json.load(f)
        self.items = list(data.values()) if isinstance(data, dict) else data
        self.tokenizer = tokenizer
        if hasattr(tokenizer, "add_tokens"):
            tokenizer.add_tokens(["<|image|>", "<|facial|>"])
        self.facial_token_id = tokenizer.convert_tokens_to_ids("<|facial|>")
        self.size = size
        self.clip_size = clip_size
        self.image_root = image_root
        self.max_num_facials = max_num_facials
        self.text_drop_prob = text_drop_prob
        self.image_drop_prob = image_drop_prob
        self.id_dim = id_dim
        self.decode = decode
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.items)

    def _path(self, p):
        return p if os.path.isabs(p) else os.path.join(self.image_root, p)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        """A broken sample is replaced by sample 0 and logged, as the
        reference's fallback (utils_SDXL.py:85-100, utils.py:102-107), so a
        bad record cannot end a long run; sample 0 itself raises."""
        try:
            return self._load_item(i)
        except Exception as e:  # noqa: BLE001
            if i == 0:
                raise
            logging.getLogger(__name__).warning(
                "FGID sample %d failed (%s); substituting sample 0", i, e)
            return self._load_item(0)

    def _load_item(self, i: int) -> Dict[str, np.ndarray]:
        item = self.items[i]
        image = as_rgb(read_array(self._path(item["image_path"]),
                                  self.decode))
        parsing = as_grey(read_array(self._path(item["parsing_mask_path"]),
                                     self.decode))
        faceid = np.zeros((self.id_dim,), np.float32)
        fp = item.get("faceid_path")
        if fp and os.path.exists(self._path(fp)):
            faceid = np.fromfile(self._path(fp), np.float32)[:self.id_dim]

        caption = item.get("vqa_llva", "")
        detail = item.get("vqa_llva_more_face_detail", "")
        return self.build_example(image, parsing, faceid, caption, detail)

    def build_example(self, image: np.ndarray, parsing: np.ndarray,
                      faceid: np.ndarray, caption: str,
                      detail: str) -> Dict[str, np.ndarray]:
        all_masks = masks_for_unique_values(parsing)
        region_masks = select_key_regions(all_masks)
        detail_aligned, region_masks = process_text_with_markers(
            detail, region_masks)

        # caption composition with overflow fallbacks (reference
        # utils.py:97-107)
        text = caption + "Detail:" + detail_aligned
        if len(self.tokenizer.encode(text)) > self.tokenizer.model_max_length:
            text = "Detail:" + detail_aligned + " Caption:" + caption
        if len(text) > 340:
            text = caption

        # CFG dropout (reference utils.py:111-118): 10% drop text, then 10%
        # of the remainder drop both text and image conditioning
        drop_image = False
        p = self.rng.random()
        if p < self.text_drop_prob:
            text = ""
        elif p < self.text_drop_prob * 2:
            text = ""
            drop_image = True

        clean_ids, img_mask, fac_mask = tokenize_and_mask_trigger_ends(
            text, None, self.facial_token_id, self.tokenizer)
        _, _, facial_idx, facial_idx_mask = prepare_trigger_token_idx(
            img_mask, fac_mask, 1, self.max_num_facials)

        regions = np.zeros((self.max_num_facials, self.clip_size,
                            self.clip_size, 3), np.float32)
        segmaps = np.zeros((self.max_num_facials, self.size, self.size),
                           np.float32)
        for j, mask in enumerate(region_masks.values()):
            if j >= self.max_num_facials:
                break
            masked = fetch_mask_raw_image(image, mask)
            regions[j] = clip_preprocess(masked, self.clip_size)[0]
            segmaps[j] = center_crop_mask(mask, self.size)

        bg = all_masks.get("WithoutBackground")
        bg_mask = (center_crop_mask(bg, self.size) if bg is not None
                   else np.ones((self.size, self.size), np.float32))

        face_pixels = clip_preprocess(image, self.clip_size)[0]
        if drop_image:
            face_pixels = np.zeros_like(face_pixels)

        return {
            "images": sd_image_preprocess(image, self.size, self.size)[0],
            "clean_ids": clean_ids[0].astype(np.int32),
            "face_pixels": face_pixels,
            "region_pixels": regions,
            "faceid_embeds": faceid.astype(np.float32),
            "facial_idx": facial_idx[0].astype(np.int32),
            "facial_idx_mask": facial_idx_mask[0],
            "region_masks": segmaps,
            "bg_masks": bg_mask,
        }

    def batches(self, batch_size: int, shuffle: bool = True, epochs: int = 1,
                workers: int = 0, prefetch: Optional[int] = None):
        """Yield stacked fixed-shape batches, in schedule order.

        workers > 0 builds up to `prefetch` batches at once on a thread pool
        (the reference's DataLoader num_workers, train.py:201-207) while the
        device runs the head: decoding and resizing release the GIL in
        part. The CFG-dropout draws then interleave across threads, as in
        torch's worker pool, so workers > 0 gives up exact dropout
        reproducibility (the content for a given index is unchanged)."""
        order = list(range(len(self)))

        def index_batches():
            for _ in range(epochs):
                if shuffle:
                    self.rng.shuffle(order)
                for start in range(0, len(order) - batch_size + 1,
                                   batch_size):
                    yield list(order[start:start + batch_size])

        def build(idxs):
            examples = [self[j] for j in idxs]
            return {k: np.stack([e[k] for e in examples])
                    for k in examples[0]}

        if workers <= 0:
            for idxs in index_batches():
                yield build(idxs)
            return

        import itertools
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        depth = prefetch if prefetch is not None else 2 * workers
        gen = index_batches()
        with ThreadPoolExecutor(workers) as pool:
            queue = deque(pool.submit(build, idxs)
                          for idxs in itertools.islice(gen, depth))
            while queue:
                head = queue.popleft()
                nxt = next(gen, None)
                if nxt is not None:
                    queue.append(pool.submit(build, nxt))
                yield head.result()


def synthetic_batch(batch_size: int = 2, size: int = 64, clip_size: int = 28,
                    id_dim: int = 512, text_len: int = 77,
                    max_num_facials: int = 5, seed: int = 0,
                    vocab: int = 49408) -> Dict[str, np.ndarray]:
    """Random batch with the exact train_step schema (tests, smoke runs)."""
    rng = np.random.RandomState(seed)
    idx = np.tile(np.array([[3, 7, 11, 0, 0]], np.int32)[:, :max_num_facials],
                  (batch_size, 1))
    mask = np.tile(np.array([[True, True, True, False, False]]
                            [0][:max_num_facials]), (batch_size, 1))
    return {
        "images": rng.randn(batch_size, size, size,
                            3).astype(np.float32) * 0.5,
        "clean_ids": rng.randint(1, vocab - 3,
                                 (batch_size, text_len)).astype(np.int32),
        "face_pixels": rng.randn(batch_size, clip_size, clip_size,
                                 3).astype(np.float32),
        "region_pixels": rng.randn(batch_size, max_num_facials, clip_size,
                                   clip_size, 3).astype(np.float32),
        "faceid_embeds": rng.randn(batch_size, id_dim).astype(np.float32),
        "facial_idx": idx,
        "facial_idx_mask": mask,
        "region_masks": (rng.rand(batch_size, max_num_facials, size,
                                  size) > 0.5).astype(np.float32),
        "bg_masks": (rng.rand(batch_size, size, size) > 0.3
                     ).astype(np.float32),
    }
