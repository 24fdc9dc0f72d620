"""CLI: precompute the frozen-encoder conditioning of an FGID corpus for
training (the JAX package's apps/precompute.py), on the card unless
`--device cpu` is given.

    python -m consistentid_torch.apps.precompute \\
        --base /path/sd15 --image-encoder /path/vit-h.safetensors \\
        --manifest JSON_all.json --data-root /data/fgid --out /data/encoded

then train from the cache, which skips the VAE, ViT-H and CLIP-text
forwards of every step (training/precompute.py):

    python -m consistentid_torch.apps.train \\
        --encoded --manifest /data/encoded/encoded_manifest.json ...

Images and parsing maps are PNG (or .npy); there is no JPEG decoder.
"""
from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--base", default=None,
                   help="diffusers SD1.5 dir (required unless --tiny); its "
                        "vae/ and text_encoder/ are read")
    p.add_argument("--tiny", action="store_true",
                   help="tiny random-weight bundle (tests, smoke runs)")
    p.add_argument("--image-encoder", default=None,
                   help="CLIP ViT-H checkpoint")
    p.add_argument("--manifest", required=True, help="FGID JSON_all.json")
    p.add_argument("--data-root", default="")
    p.add_argument("--tokenizer", default=None,
                   help="CLIP tokenizer dir (vocab.json + merges.txt); "
                        "default: the word-hash SimpleTokenizer")
    p.add_argument("--out", required=True, help="output cache directory")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--dtype", choices=["bf16", "fp32"], default="bf16")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback between them")
    return p


def make_tokenizer(path):
    """CLIPBPETokenizer from a dir, else the word-hash SimpleTokenizer (the
    JAX CLIs' default); the trigger tokens registered."""
    from ..conditioning import CLIPBPETokenizer, SimpleTokenizer
    tok = (CLIPBPETokenizer.from_pretrained(path) if path
           else SimpleTokenizer())
    tok.add_tokens(["<|image|>", "<|facial|>"])
    return tok


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from ..training import FGIDDataset, precompute_conditioning

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    if args.tiny:
        from ..testing import tiny_bundle
        bundle = tiny_bundle(device=args.device, dtype=dtype, seed=args.seed)
    else:
        if not args.base:
            raise SystemExit("--base is required unless --tiny")
        from ..core import AdapterConfig, sd15_unet_config
        from ..pipelines import SD15Bundle
        from ..pipelines.loading import load_models
        bundle = SD15Bundle(unet_config=sd15_unet_config(),
                            adapter_config=AdapterConfig(), dtype=dtype,
                            device=args.device, seed=args.seed)
        load_models(bundle, args.base, image_encoder_path=args.image_encoder,
                    with_unet=False)

    dataset = FGIDDataset(args.manifest, make_tokenizer(args.tokenizer),
                          size=args.resolution, image_root=args.data_root,
                          seed=args.seed,
                          clip_size=bundle.vision_config.image_size,
                          id_dim=bundle.adapter_config.id_embeddings_dim)
    path = precompute_conditioning(bundle, dataset, args.out,
                                   batch_size=args.batch_size)
    print(f"encoded manifest -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
