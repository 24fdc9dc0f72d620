"""Identity and text-fidelity metrics for the FGIS benchmark (the JAX
package's eval/metrics.py), on the port bundle's device.

The reference repo defines the evaluation protocol (15 identities x 45
prompts, evaluation/EvaluationIMGs_stars_prompts.csv) but ships no scoring
code. These are the paper's two headline metrics:
  - FaceSim: cosine similarity of ArcFace embeddings between the generated
    face and the reference face (models/arcface.py's embedder hook);
  - CLIP-T: CLIP similarity between the generated image and the prompt
    (the pooled text output against the vision tower's post-layernorm CLS,
    each through its projection when one is given).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..utils.image import clip_preprocess


def face_similarity(embed_a: np.ndarray, embed_b: np.ndarray) -> float:
    """Cosine similarity of two (1, D) L2-normalizable embeddings."""
    a = np.asarray(embed_a, np.float32).reshape(-1)
    b = np.asarray(embed_b, np.float32).reshape(-1)
    denom = (np.linalg.norm(a) * np.linalg.norm(b)) or 1e-8
    return float(a @ b / denom)


class FaceSimScorer:
    """Scores generated images against a reference identity embedding."""

    def __init__(self, face_embedder: Callable):
        self.face_embedder = face_embedder

    def __call__(self, reference_image, generated_image) -> float:
        ref = self.face_embedder(reference_image)
        gen = self.face_embedder(generated_image)
        return face_similarity(ref, gen)


class CLIPTScorer:
    """CLIP-T: normalized text/image agreement through the bundle's CLIP
    towers (`text_encoder`, `image_encoder`), run in the bundle's dtype on
    its device. With converted projection heads pass
    `text_projection` / `visual_projection` ((D_text or D_vis, shared)
    arrays), applied in fp32."""

    def __init__(self, bundle, tokenizer,
                 text_projection: Optional[np.ndarray] = None,
                 visual_projection: Optional[np.ndarray] = None):
        self.bundle = bundle
        self.tokenizer = tokenizer
        t_dim = bundle.text_config.hidden_size if text_projection is None \
            else np.asarray(text_projection).shape[1]
        v_dim = bundle.vision_config.hidden_size \
            if visual_projection is None \
            else np.asarray(visual_projection).shape[1]
        if t_dim != v_dim:
            raise ValueError(
                f"CLIP-T needs a shared embedding space: text {t_dim} vs "
                f"vision {v_dim}; pass the CLIP text_projection / "
                "visual_projection weights")
        device = bundle.device

        def weight(w):
            return None if w is None else torch.as_tensor(
                np.asarray(w, np.float32), device=device)

        self.text_projection = weight(text_projection)
        self.visual_projection = weight(visual_projection)

    @torch.no_grad()
    def __call__(self, prompt: str, image: np.ndarray) -> float:
        tok, bundle = self.tokenizer, self.bundle
        ids = list(tok.encode(prompt))[: tok.model_max_length]
        ids += [tok.pad_token_id] * (tok.model_max_length - len(ids))
        pixels = clip_preprocess(image, bundle.vision_config.image_size)
        _, pooled_t = bundle.call(bundle.text_encoder, torch.tensor(
            [ids], dtype=torch.long, device=bundle.device))
        post, _ = bundle.call(bundle.image_encoder,
                              torch.from_numpy(pixels).to(bundle.device))
        pooled_t, pooled_v = pooled_t.float(), post[:, 0].float()
        if self.text_projection is not None:
            pooled_t = pooled_t @ self.text_projection
        if self.visual_projection is not None:
            pooled_v = pooled_v @ self.visual_projection
        t = pooled_t / torch.linalg.vector_norm(pooled_t, dim=-1,
                                                keepdim=True)
        v = pooled_v / torch.linalg.vector_norm(pooled_v, dim=-1,
                                                keepdim=True)
        return float((t * v).sum(-1)[0])
