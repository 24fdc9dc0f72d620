"""Tiny random-weight bundles, random perception weights and a synthetic
tokenizer for tests and smoke runs, and the limits the card checks hold the
kernels and the perception models to. `tiny_bundle` and `tiny_sdxl_bundle`
have the sizes of the JAX package's tiny SD1.5 and SDXL bundles, so the same
parameters load into both."""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, Union

import torch
from torch import nn

from .core import (AdapterConfig, CLIPTextConfig, CLIPVisionConfig,
                   UNetConfig, VAEConfig)

# Limits of the card checks (chip_smoke.py, tests/test_torch_cuda.py) on a
# flash kernel's output against its plain version, as relative L2 errors
# ||kernel - plain|| / ||plain|| over the whole tensor, set just above what
# the kernels read on an H100 and below what a control reads (PERF.md).
# 16-bit inputs: the kernels round P (and dS) to the input type before
# their products and every output once more; bf16 reads up to 2.45e-3 on
# random inputs, and the plain version with its last key or query tile
# dropped (`drop_last_tile`) 0.11 and more. fp32: the SIMT kernels,
# summation order only (up to 9.1e-7).
KERNEL_REL_L2_16BIT = 4e-3
KERNEL_REL_L2_FP32 = 1e-5
# K3 and K4 against the plain backward at their own precision
# (`flash_attention_bwd_plain(..., round_to=dtype)`, outputs rounded to
# dtype): only fp32 summation order, flipping a rounding here and there
# (up to 3.3e-4 read; the dropped-tile controls 0.057 and more).
KERNEL_REL_L2_SAME_PRECISION = 1e-3
# K5 (batch_moments) against its plain version, relative L2 of mean and of
# var: both sum in fp32, in another order (spans of rows, clusters and
# fixed trees against torch's reduction); inputs with channel offsets keep
# mean and var of order 1, so the error is a few fp32 ulps of E[x^2]. The
# control, the plain moments with the last cluster's rows never summed
# (`moments_without_last_cluster`), reads at least that cluster's share of
# the rows (1/33 at BiSeNet's stem). The card checks also hold K5's bits
# equal to `moments_in_kernel_order`.
KERNEL_BN_MOMENTS_REL_L2 = 1e-5
# K6 (apply_bn_act) against its plain version: the kernel rounds each of
# JAX's operations on its own, in the same order as the plain version's
# separate torch ops, on the same inv, so fp32 differs only where silu's
# exp does (a few ulps); 16-bit outputs round the same fp32 values, except
# where such an ulp moves one across a rounding boundary (one bf16 ulp,
# 2^-8, on rare elements). The control, the last 8 channels left
# unnormalized, reads 0.1 and more.
KERNEL_BN_APPLY_REL_L2_FP32 = 1e-6
KERNEL_BN_APPLY_REL_L2_16BIT = 1e-4
BN_CONTROL_CHANNELS = 8
# The perception models in fp32 on the card (TF32 off) against the CPU, as
# relative L2 over each output (chip_smoke.py's perception check, PERF.md):
# each network on the same input, summation order only over up to 50
# layers (first reading on an H100: at most 8.2e-7 for BiSeNet's logits);
PERCEPTION_REL_L2 = 1e-4
# the detector's aligned crop and the embedder hook's output, downstream of
# the keypoints, which move with the head maps' summation order (first
# reading 5.1e-5 and 1.4e-4);
PERCEPTION_CHAIN_REL_L2 = 1e-3
# and the share of BiSeNet label pixels that agree (first reading 0.999996).
PERCEPTION_LABEL_AGREEMENT = 0.999


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / ||ref|| over the whole tensor, in fp32."""
    ref = ref.float()
    return ((got.float() - ref).norm() / ref.norm()).item()


@contextmanager
def tf32_off():
    """fp32 matmuls and cuDNN convolutions in full fp32 inside the block
    (cuDNN defaults to TF32), for the card-against-CPU checks."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@contextmanager
def deterministic():
    """Deterministic CUDA algorithms inside the block (torch's flag, warn
    only, and cuDNN's), for card checks that compare two runs bit for bit
    or nearly: on the card `torch.gather`'s backward, which the attention
    capture takes, otherwise adds with atomics in any order, and AdamW turns
    that noise in a near-zero gradient into a step of either sign."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic = saved[2]


def drop_last_tile(n: int, tile: int = 64) -> int:
    """How many of n rows a kernel keeps that skips its last `tile`-row
    tile, or the ragged tail past the last whole tile: the control the card
    checks must tell apart from the kernel."""
    return (n - 1) // tile * tile


def _lane_sums(rows: torch.Tensor, lanes: int) -> torch.Tensor:
    """Per-channel fp32 sums of the rows of each group of `rows` (groups,
    n, C), as a CTA of K5 takes them: `lanes` row lanes, lane l adding rows
    l, l + lanes, ... in order from 0 (zero rows pad the last step: adding
    0 changes no sum), then a fixed pairwise tree over the lanes, lane l
    adding lane l + stride for l a multiple of 2 * stride, stride = 1, 2,
    ... lanes / 2. Each addition is one rounded fp32 operation, as in the
    kernel. Returns (groups, C)."""
    groups, n, c = rows.shape
    steps = -(-n // lanes)
    pad = rows.new_zeros((groups, steps * lanes - n, c))
    rows = torch.cat([rows, pad], 1).view(groups, steps, lanes, c)
    acc = rows.new_zeros((groups, lanes, c))
    for k in range(steps):
        acc = acc + rows[:, k]
    stride = 1
    while stride < lanes:
        acc[:, ::2 * stride] += acc[:, stride::2 * stride]
        stride *= 2
    return acc[:, 0]


def moments_in_kernel_order(x: torch.Tensor, plan):
    """K5's mean and var of an NHWC tensor in plain torch, summed in the
    order the kernel launched with `plan` (`ops.fused_bn_act.bn_plan`)
    sums: each CTA's span of rows over its row lanes, then its tree; the
    CTAs of a cluster in rank order; the clusters' partial rows as a CTA
    sums rows, over `plan.final_lanes` lanes. Squares are rounded before
    they are added. Then mean = S / rows and var = Q / rows - mean^2, each
    a rounded fp32 operation (a true division by a tensor: torch divides
    by a Python number as a product with its reciprocal). On the card the
    kernel's bits equal these; channel tiles and vector widths do not
    change a channel's order."""
    c = x.shape[-1]
    rows = x.numel() // c
    xf = x.reshape(rows, c).float()
    spans = torch.cat([xf, xf.new_zeros((plan.ctas * plan.rows_per_cta
                                         - rows, c))])
    spans = spans.view(plan.ctas, plan.rows_per_cta, c)
    sums = []
    for part in (spans, spans * spans):
        ranks = _lane_sums(part, plan.row_lanes).view(plan.partial_rows,
                                                      plan.cluster, c)
        acc = ranks[:, 0]
        for r in range(1, plan.cluster):
            acc = acc + ranks[:, r]
        sums.append(_lane_sums(acc.unsqueeze(0), plan.final_lanes)[0])
    s, q = sums
    n = torch.full_like(s, float(rows))
    mean = s / n
    return mean, q / n - mean * mean


def moments_without_last_cluster(x: torch.Tensor, plan):
    """The control of K5's card check: the plain moments of an NHWC tensor
    with the rows of the last cluster of `plan` never summed (still divided
    by all the rows), as a kernel that lost a cluster's partial row would
    give them."""
    c = x.shape[-1]
    rows = x.numel() // c
    keep = (plan.partial_rows - 1) * plan.cluster * plan.rows_per_cta
    xf = x.reshape(rows, c)[:min(keep, rows)].float()
    mean = xf.sum(0) / rows
    return mean, (xf * xf).sum(0) / rows - mean * mean


def unnormalized_last_channels(x: torch.Tensor, y: torch.Tensor,
                               n: int = BN_CONTROL_CHANNELS) -> torch.Tensor:
    """The control of K6's card check: the plain output y with its last n
    channels left as x, as a kernel that skipped a channel tile would."""
    out = y.clone()
    out[..., -n:] = x[..., -n:]
    return out


@torch.no_grad()
def randomize_perception_module(module: nn.Module,
                                generator: torch.Generator) -> None:
    """Seeded random weights for a perception model, in place, such that a
    random stack of 50 layers stays finite and non-degenerate: He-scaled
    conv weights (std sqrt(2 / fan_in)), linear weights of std
    1 / sqrt(fan_in), BatchNorm scale 1 + N(0, 0.1^2), bias and running mean
    N(0, 0.1^2), running variance U(0.5, 1.5); unit LayerNorm and GroupNorm
    scales, PReLU slopes 0.25, SCRFD's box scales 1; the safety checker's
    concept banks N(0, 1) and their thresholds U(0.15, 0.25); biases and
    embeddings N(0, 0.02^2). In a residual block (a module with `has_downsample`) the
    last BatchNorm of the residual branch gets scale N(0, 0.1^2), the
    small-scale residual start of ResNet training: else each of SCRFD-10g's
    14 blocks doubles the activations, the head's scores saturate and the
    keypoints leave the image."""
    dev = generator.device
    closing = set()
    for mod in module.modules():
        if hasattr(mod, "has_downsample"):
            norms = [m for n, m in mod.named_children()
                     if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d))
                     and not n.startswith("downsample")]
            closing.add(id(norms[-1]))

    def normal(t, std, mean=0.0):
        t.copy_(torch.randn(t.shape, generator=generator, device=dev) * std
                + mean)

    for mod in module.modules():
        for leaf, t in [*mod.named_parameters(recurse=False),
                        *mod.named_buffers(recurse=False)]:
            if isinstance(mod, (nn.BatchNorm1d, nn.BatchNorm2d)):
                if leaf == "weight":
                    normal(t, 0.1, 0.0 if id(mod) in closing else 1.0)
                elif leaf in ("bias", "running_mean"):
                    normal(t, 0.1)
                elif leaf == "running_var":
                    t.copy_(torch.rand(t.shape, generator=generator,
                                       device=dev) + 0.5)
                else:
                    t.zero_()                     # num_batches_tracked
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                t.fill_(1.0 if leaf == "weight" else 0.0)
            elif type(mod).__name__ == "PReLU":
                t.fill_(0.25)
            elif leaf.startswith("scale_"):
                t.fill_(1.0)
            elif leaf == "weight" and t.dim() >= 2:
                fan_in = t[0].numel()
                normal(t, math.sqrt(2.0 / fan_in) if t.dim() == 4
                       else 1.0 / math.sqrt(fan_in))
            elif leaf.endswith("_embeds"):
                normal(t, 1.0)
            elif leaf.endswith("_embeds_weights"):   # checker thresholds
                t.copy_(torch.rand(t.shape, generator=generator,
                                   device=dev) * 0.1 + 0.15)
            else:
                normal(t, 0.02)


def random_perception_state(generator: torch.Generator
                            ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Seeded random state dicts, on the generator's device, for the
    perception models at full width: SCRFD-10g ("detector"), iresnet50 at
    112 px to 512-d ("embedder"), BiSeNet with 19 classes ("parser") and the
    ViT-L/14 safety checker ("safety_checker")."""
    from .models.arcface import IResNet
    from .models.bisenet import BiSeNet
    from .models.safety_checker import SafetyChecker
    from .models.scrfd import SCRFD, SCRFD_VARIANTS

    builders = {"detector": lambda: SCRFD(SCRFD_VARIANTS["scrfd_10g"]),
                "embedder": IResNet, "parser": BiSeNet,
                "safety_checker": SafetyChecker}
    states = {}
    for name, build in builders.items():
        with torch.device("meta"):
            model = build()
        model.to_empty(device=generator.device)
        randomize_perception_module(model, generator)
        states[name] = model.state_dict()
    return states


def tiny_bundle(device: Union[str, torch.device] = "cuda",
                dtype: torch.dtype = torch.float32, seed: int = 0,
                sample_channels: int = 4):
    """A complete SD1.5 ConsistentID bundle at toy scale (random weights);
    sample_channels=9: the inpainting UNet's input (latents, mask and
    masked-image latents)."""
    from .pipelines import SD15Bundle

    return SD15Bundle(
        unet_config=UNetConfig(
            sample_channels=sample_channels,
            block_out_channels=(32, 32, 64, 64),
            layers_per_block=1,
            num_attention_heads=(2, 2, 2, 2),
            cross_attention_dim=64,
            norm_num_groups=8,
            lora_rank=4,
            ip_num_tokens=4,
        ),
        adapter_config=AdapterConfig(
            cross_attention_dim=64,
            id_embeddings_dim=16,
            clip_embeddings_dim=32,
            num_id_tokens=4,
            facial_dim=64,
            facial_depth=2,
            facial_heads=2,
            facial_output_dim=64,
        ),
        vae_config=VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                             norm_num_groups=8),
        text_config=CLIPTextConfig(hidden_size=64, intermediate_size=128,
                                   num_layers=2, num_heads=2),
        vision_config=CLIPVisionConfig(image_size=28, patch_size=14,
                                       hidden_size=32, intermediate_size=64,
                                       num_layers=2, num_heads=2),
        dtype=dtype, device=device, seed=seed)


def tiny_controlnet(unet_config: UNetConfig,
                    device: Union[str, torch.device] = "cuda",
                    dtype: torch.dtype = torch.float32, seed: int = 0):
    """A ControlNet over a tiny bundle's UNet config: the tiny VAE halves
    the image once, so the control pyramid has one stride-2 conv
    (16, 32); 4 latent channels in."""
    from .models.controlnet import make_controlnet

    return make_controlnet(unet_config, cond_embed_channels=(16, 32),
                           in_channels=4, dtype=dtype, device=device,
                           seed=seed)


def tiny_sdxl_bundle(device: Union[str, torch.device] = "cuda",
                     dtype: torch.dtype = torch.float32, seed: int = 0,
                     force_upcast: bool = False):
    """A complete SDXL ConsistentID bundle at toy scale (random weights):
    three UNet levels, the first without attention, linear transformer
    projections and the text_time embedding, two text towers (the second
    with gelu) whose penultimate states concatenate to the 96-wide
    context."""
    from .pipelines import SDXLBundle

    return SDXLBundle(
        unet_config=UNetConfig(
            block_out_channels=(32, 64, 64),
            layers_per_block=1,
            down_block_has_attn=(False, True, True),
            transformer_layers_per_block=(0, 1, 2),
            mid_transformer_depth=2,
            num_attention_heads=(2, 2, 4),
            cross_attention_dim=96,          # 32 + 64 dual-tower concat
            norm_num_groups=8,
            addition_embed_type="text_time",
            addition_time_embed_dim=8,
            projection_class_embeddings_input_dim=8 * 6 + 64,
            lora_rank=4,
            ip_num_tokens=4,
        ),
        adapter_config=AdapterConfig(
            cross_attention_dim=96, id_embeddings_dim=16,
            clip_embeddings_dim=32, facial_dim=64, facial_depth=2,
            facial_heads=2, facial_output_dim=96, shortcut=True),
        vae_config=VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                             norm_num_groups=8, scaling_factor=0.13025,
                             force_upcast=force_upcast),
        text_config=CLIPTextConfig(hidden_size=32, intermediate_size=64,
                                   num_layers=2, num_heads=2),
        text_config_2=CLIPTextConfig(hidden_size=64, intermediate_size=128,
                                     num_layers=2, num_heads=2,
                                     hidden_act="gelu"),
        vision_config=CLIPVisionConfig(image_size=28, patch_size=14,
                                       hidden_size=32, intermediate_size=64,
                                       num_layers=2, num_heads=2),
        dtype=dtype, device=device, seed=seed)


def synthetic_clip_tokenizer():
    """CLIPBPETokenizer over a universal byte-level vocab (full byte
    alphabet + </w> word-end forms, no merges): encodes any text through the
    production BPE code path where no real vocab.json exists. Token ids do
    not match the real CLIP vocab."""
    from .conditioning import CLIPBPETokenizer
    from .conditioning.clip_tokenizer import bytes_to_unicode

    syms = list(bytes_to_unicode().values())
    tokens = (syms + [s + "</w>" for s in syms]
              + ["<|startoftext|>", "<|endoftext|>"])
    vocab = {t: i for i, t in enumerate(dict.fromkeys(tokens))}
    return CLIPBPETokenizer(vocab, [])


# The tiny LLaVA of the CPU parity tests and the card checks: a 2-layer
# ViT at 28 px (4 patches) and a 2-layer GQA Llama over a 512-entry
# vocab (the size of `synthetic_llama_tokenizer_json(512)`); every product
# width a multiple of 8, as torch._int_mm takes under int8
TINY_LLAVA_VISION = dict(image_size=28, patch_size=14, hidden_size=24,
                         intermediate_size=48, num_layers=2, num_heads=2,
                         hidden_act="quick_gelu")
TINY_LLAVA_TEXT = dict(vocab_size=512, hidden_size=32, intermediate_size=64,
                       num_layers=2, num_heads=4, num_kv_heads=2,
                       max_position_embeddings=512)


def tiny_llava_config():
    from .core.config import LlamaConfig, LlavaConfig
    return LlavaConfig(vision=CLIPVisionConfig(**TINY_LLAVA_VISION),
                       text=LlamaConfig(**TINY_LLAVA_TEXT),
                       image_token_id=TINY_LLAVA_TEXT["vocab_size"] - 1)


# A small English corpus for `synthetic_llama_tokenizer_json`'s merges: the
# FGID prompts, the llava_v1 system text and facial words, so those texts
# tokenize into multi-character pieces as they would with a trained vocab
_LLAMA_CORPUS = (
    "A chat between a curious human and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite answers "
    "to the human's questions. USER: ASSISTANT: Please describe the people "
    "in the image, including their gender, age, clothing, facial "
    "expressions, and any other distinguishing features. Describe this "
    "person's facial features for me, including face, ears, eyes, nose, "
    "and mouth. The person has one face, one nose, two eyes, two ears, and "
    "one mouth. a photo of a woman with long hair and a man with a beard "
    "smiling, wearing glasses, a shirt and a jacket outdoors.")


def synthetic_llama_tokenizer_json(vocab_size: int = 32000,
                                   seed: int = 0) -> Dict:
    """A Llama-2-style HF tokenizer.json (the llava-hf kind: Prepend and
    Replace "▁" normalizer, BPE with byte fallback, "<s> $A" template,
    ByteFallback / Fuse / Strip decoder) of `vocab_size` entries: <unk>,
    <s>, </s>, the 256 byte tokens, the corpus's characters, merges
    learned on the corpus by pair counts, then seeded random merges of
    existing pieces (a "▁" only at a piece's start) up to the size. Ids
    do not match the real Llama vocab; the format does."""
    import random

    rng = random.Random(seed)
    vocab: Dict[str, int] = {}
    for t in ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]:
        vocab[t] = len(vocab)
    chars = sorted(set("▁" + _LLAMA_CORPUS.replace(" ", "▁")
                       + "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                       + "0123456789.,;:!?'\"()-éüñ"))
    for c in chars:
        vocab.setdefault(c, len(vocab))
    merges = []

    def add_merge(a, b):
        merges.append(f"{a} {b}")
        vocab[a + b] = len(vocab)

    words = [list("▁" + w) for w in _LLAMA_CORPUS.split()]
    while len(vocab) < vocab_size:
        counts: Dict = {}
        for w in words:
            for pair in zip(w, w[1:]):
                counts[pair] = counts.get(pair, 0) + 1
        if not counts:
            break
        pair, n = max(counts.items(), key=lambda kv: (kv[1], kv[0]))
        if n < 2:
            break
        add_merge(*pair)
        for w in words:
            i = 0
            while i < len(w) - 1:
                if (w[i], w[i + 1]) == pair:
                    w[i:i + 2] = [pair[0] + pair[1]]
                i += 1
    pieces = [t for t in vocab if not t.startswith("<")]
    tails = [t for t in pieces if not t.startswith("▁")]
    while len(vocab) < vocab_size:
        a, b = rng.choice(pieces), rng.choice(tails)
        if a + b in vocab or len(a + b) > 16:
            continue
        add_merge(a, b)
        pieces.append(a + b)
        if not a.startswith("▁"):
            tails.append(a + b)
    special = dict(single_word=False, lstrip=False, rstrip=False,
                   normalized=False, special=True)
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [dict(id=i, content=t, **special)
                         for i, t in enumerate(["<unk>", "<s>", "</s>"])],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "},
             "content": "▁"}]},
        "pre_tokenizer": None,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "<s>", "type_id": 1}},
                     {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {"<s>": {"id": "<s>", "ids": [1],
                                       "tokens": ["<s>"]}}},
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": True,
                  "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": merges},
    }


def write_llama_tokenizer(model_dir: str, vocab_size: int = 32000,
                          seed: int = 0) -> None:
    """`synthetic_llama_tokenizer_json` as model_dir/tokenizer.json, with
    the tokenizer_config.json naming its bos and eos."""
    import json
    import os

    with open(os.path.join(model_dir, "tokenizer.json"), "w",
              encoding="utf-8") as f:
        json.dump(synthetic_llama_tokenizer_json(vocab_size, seed), f,
                  ensure_ascii=False)
    with open(os.path.join(model_dir, "tokenizer_config.json"), "w",
              encoding="utf-8") as f:
        json.dump({"bos_token": "<s>", "eos_token": "</s>",
                   "unk_token": "<unk>"}, f)
