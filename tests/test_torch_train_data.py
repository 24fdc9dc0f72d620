"""The PyTorch port's training data against the JAX package on the CPU:
the LANCZOS resize of `sd_image_preprocess` (numpy in the port, PIL in
JAX), FGIDDataset item by item on one PNG corpus and seed, the bf16 storage
of pack_float / unpack_float, precompute_conditioning against JAX's frozen
encoders on the same examples (the tiny bundle, fp32, numpy-drawn
parameters carried across with params_from_jax), and EncodedFGIDDataset's
dropout branches against JAX's on the same cache.

Limits: the LANCZOS resize at most one grey level a pass (it reads 0: the
port repeats PIL's fixed-point arithmetic); integer, boolean and mask
fields equal; CLIP pixels equal (the port's bicubic is PIL's fixed-point
one in numpy); cached tensors relative L2 1e-5 (fp32,
summation order only). JAX's encoders are jitted once.
"""
import json

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from consistentid_tpu.conditioning import SimpleTokenizer as JaxTokenizer
from consistentid_tpu.conditioning import \
    tokenize_and_mask_trigger_ends as jax_tokenize_and_mask_trigger_ends
from consistentid_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from consistentid_tpu.testing import tiny_bundle as jax_tiny_bundle
from consistentid_tpu.training import dataset as jax_dataset
from consistentid_tpu.training import precompute as jax_precompute
from consistentid_tpu.utils import image as jax_image
from consistentid_torch.conditioning import SimpleTokenizer
from consistentid_torch.io import params_from_jax
from consistentid_torch.testing import rel_l2, tiny_bundle
from consistentid_torch.training import (EncodedFGIDDataset, FGIDDataset,
                                         pack_float, precompute_conditioning,
                                         unpack_float)
from consistentid_torch.utils.image import sd_image_preprocess
from consistentid_torch.utils.png import decode_png, encode_png
from test_torch_loading import one_torch_thread  # noqa: F401
from test_torch_training import _bundle_params

GREY = 2.0 / 255.0          # one grey level in [-1, 1]
SIZE, CLIP = 32, 28         # the examples' image and CLIP sizes
N_ITEMS = 4


@pytest.mark.parametrize("src,dst", [((64, 64), (32, 32)),
                                     ((48, 40), (100, 90)),
                                     ((37, 53), (37, 53)),
                                     ((64, 48), (64, 20)),
                                     ((90, 70), (30, 140))])
def test_sd_image_preprocess_matches_pil(src, dst):
    """Downscale, upscale, the identity and one axis at a time, on noise
    and on a smooth ramp: within one grey level a pass of JAX's PIL
    LANCZOS."""
    rng = np.random.RandomState(sum(src) + sum(dst))
    (h, w), (oh, ow) = src, dst
    ramp = np.linspace(0, 255, h * w * 3).reshape(h, w, 3).astype(np.uint8)
    passes = int(h != oh) + int(w != ow)
    for img in (rng.randint(0, 256, (h, w, 3)).astype(np.uint8), ramp):
        want = jax_image.sd_image_preprocess(Image.fromarray(img), oh, ow)
        got = sd_image_preprocess(img, oh, ow)
        assert got.shape == want.shape == (1, oh, ow, 3)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=max(passes, 0) * GREY + 1e-6)


def _write_corpus(root, n=N_ITEMS, jpeg_first=False):
    """n PNG faces (64 px, noise) with grey BiSeNet-label parsing maps
    (face, eyes, nose, lip and ear blobs, a neck reaching the bottom edge,
    a background that does not enclose them), a FaceID .bin for
    all but the last, and captions with facial words; item 0 a JPEG file
    when asked."""
    rng = np.random.RandomState(7)
    items = []
    for i in range(n):
        img = rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
        labels = np.zeros((64, 64), np.uint8)
        labels[8:56, 10:54] = 1                  # Face
        labels[56:, 22:42] = 14                   # Neck, to the bottom edge
        labels[18:23, 16 + i:26 + i] = 4          # Left_Eye
        labels[18:23, 36:46] = 5                  # Right_Eye
        labels[28:36, 28:36] = 10                 # Nose
        labels[40:44, 22:42] = 12                 # Upper_Lip
        labels[20:34, 4:9] = 7                    # Left_Ear
        (root / f"im{i}.png").write_bytes(encode_png(img))
        (root / f"mask{i}.png").write_bytes(encode_png(labels))
        item = {"image_path": f"im{i}.png",
                "parsing_mask_path": f"mask{i}.png",
                "vqa_llva": f"a photo of person {i} in a garden.",
                "vqa_llva_more_face_detail":
                    "The person has brown eyes, a small nose, large ears "
                    "and thin lips."}
        if i < n - 1:
            rng.randn(16).astype(np.float32).tofile(root / f"id{i}.bin")
            item["faceid_path"] = f"id{i}.bin"
        items.append(item)
    if jpeg_first:
        (root / "im0.jpg").write_bytes(b"\xff\xd8\xff\xe0" + bytes(64))
        items[0]["image_path"] = "im0.jpg"
    path = root / "manifest.json"
    path.write_text(json.dumps(items))
    return str(path)


def _datasets(root, manifest, **kw):
    args = dict(size=SIZE, clip_size=CLIP, image_root=str(root), id_dim=16,
                seed=3, **kw)
    return (jax_dataset.FGIDDataset(manifest, JaxTokenizer(), **args),
            FGIDDataset(manifest, SimpleTokenizer(), **args))


def _assert_example(got, want):
    assert got.keys() == want.keys()
    for key in ("clean_ids", "facial_idx", "facial_idx_mask",
                "faceid_embeds", "region_masks", "bg_masks"):
        assert got[key].dtype == np.asarray(want[key]).dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["images"], want["images"], rtol=0,
                               atol=GREY + 1e-6)
    for key in ("face_pixels", "region_pixels"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_fgid_dataset_matches_jax(tmp_path):
    """Item by item over three passes of the corpus (the CFG-dropout draws
    in the same order: 30% text dropped, the next 30% text and image), then
    the shuffled batches of two epochs."""
    manifest = _write_corpus(tmp_path)
    jds, pds = _datasets(tmp_path, manifest, text_drop_prob=0.3)
    dropped = set()
    for i in list(range(N_ITEMS)) * 3:
        want, got = jds[i], pds[i]
        _assert_example(got, want)
        if not want["facial_idx_mask"].any():
            dropped.add(bool(np.abs(want["face_pixels"]).max() == 0))
    assert dropped == {True, False}            # both branches were taken
    for got, want in zip(pds.batches(2, epochs=2), jds.batches(2, epochs=2)):
        for k in want:
            assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got["clean_ids"], want["clean_ids"])
        np.testing.assert_array_equal(got["region_masks"],
                                      want["region_masks"])


def test_fgid_dataset_refuses_jpeg(tmp_path, caplog):
    """The default decoder is PNG only: a JPEG sample 0 raises the error
    that names it, a JPEG sample i > 0 is replaced by sample 0 and logged;
    a caller's decoder reads it."""
    manifest = _write_corpus(tmp_path, n=2, jpeg_first=True)
    _, pds = _datasets(tmp_path, manifest, text_drop_prob=0.0,
                       image_drop_prob=0.0)
    with pytest.raises(ValueError, match="JPEG"):
        pds[0]
    items = json.loads((tmp_path / "manifest.json").read_text())
    items = [items[1], items[0]]
    (tmp_path / "swapped.json").write_text(json.dumps(items))
    _, pds = _datasets(tmp_path, str(tmp_path / "swapped.json"),
                       text_drop_prob=0.0, image_drop_prob=0.0)
    with caplog.at_level("WARNING"):
        substituted = pds[1]
    assert "substituting sample 0" in caplog.text
    np.testing.assert_array_equal(substituted["images"], pds[0]["images"])
    face = np.full((64, 64, 3), 9, np.uint8)

    def decode(data):          # a caller's decoder: JPEG here, else PNG
        return face if data[:3] == b"\xff\xd8\xff" else decode_png(data)

    pds = FGIDDataset(manifest, SimpleTokenizer(), size=SIZE,
                      clip_size=CLIP, image_root=str(tmp_path), id_dim=16,
                      decode=decode)
    np.testing.assert_allclose(pds[0]["images"], 9 / 255 * 2 - 1, atol=1e-6)


def test_pack_float_matches_jax():
    """bf16 tensors as the same uint16 bit patterns, fp32 as it is; both
    unpack to the same fp32, exactly."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 5)).astype(np.float32) * 100
    for dtype in (jnp.bfloat16, jnp.float32):
        want = jax_precompute.pack_float(jnp.asarray(x, dtype))
        got = pack_float(torch.from_numpy(x).to(
            torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(unpack_float(got),
                                      jax_precompute.unpack_float(want))
    bf = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(unpack_float(pack_float(bf)),
                                  bf.float().numpy())


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """The port's cache of the corpus (tiny bundle, fp32, the JAX bundle's
    numpy-drawn parameters) and JAX's encoders, jitted once, on the same
    examples: the corpus's (dropout off) and, in row 0, the null inputs."""
    root = tmp_path_factory.mktemp("corpus")
    manifest = _write_corpus(root)
    jb = jax_tiny_bundle()
    params = _bundle_params(jb)
    bundle = tiny_bundle(device="cpu")
    bundle.load_state_dict(params_from_jax(params), strict=True)
    _, pds = _datasets(root, manifest)
    path = precompute_conditioning(bundle, pds, str(root / "enc"),
                                   batch_size=3, progress=False)

    @jax.jit
    def encode(p, images, face, regions, ids):
        mean, logvar = jb.vae.apply({"params": p["vae"]}, images,
                                    method=JaxAutoencoderKL.encode_moments)
        n = images.shape[0]
        _, penult = jb.image_encoder.apply(
            {"params": p["image_encoder"]},
            jnp.concatenate([face, regions.reshape(-1, CLIP, CLIP, 3)]))
        prompt, _ = jb.text_encoder.apply({"params": p["text_encoder"]}, ids)
        return (mean, logvar, penult[:n],
                penult[n:].reshape(n, 5, *penult.shape[1:]), prompt)

    pds.text_drop_prob = pds.image_drop_prob = 0.0
    examples = [pds[i] for i in range(N_ITEMS)]
    stacked = {k: np.stack([e[k] for e in examples]) for k in examples[0]}
    want = [np.asarray(t) for t in encode(
        params, stacked["images"], stacked["face_pixels"],
        stacked["region_pixels"], stacked["clean_ids"])]
    return dict(root=root, path=path, examples=examples, want=want,
                encode=encode, params=params, stacked=stacked, pds=pds)


def test_precompute_matches_jax_encoders(encoded):
    """Every cached tensor of every sample within relative L2 1e-5 of JAX's
    encoders on the same example; the pass-through fields as the example
    has them; the null tensors JAX's encoders on the empty caption and the
    zero image."""
    root, want = encoded["root"], encoded["want"]
    keys = ("latent_mean", "latent_logvar", "face_embeds", "region_embeds",
            "prompt_embeds")
    manifest = json.loads((root / "enc" / "encoded_manifest.json")
                          .read_text())
    assert manifest["format"] == "consistentid-encoded-v1"
    assert len(manifest["samples"]) == N_ITEMS
    for i, (rel, ex) in enumerate(zip(manifest["samples"],
                                      encoded["examples"])):
        with np.load(root / "enc" / rel) as z:
            for key, w in zip(keys, want):
                got = unpack_float(z[key])
                assert got.shape == w[i].shape, key
                ref = torch.from_numpy(np.array(w[i]))
                assert rel_l2(torch.from_numpy(got), ref) <= 1e-5, (i, key)
            np.testing.assert_array_equal(z["facial_idx"], ex["facial_idx"])
            np.testing.assert_array_equal(z["region_masks"],
                                          ex["region_masks"] > 0.5)
            np.testing.assert_array_equal(z["faceid_embeds"],
                                          ex["faceid_embeds"])

    tok = JaxTokenizer()
    tok.add_tokens(["<|image|>", "<|facial|>"])
    null_ids = jax_tokenize_and_mask_trigger_ends(
        "", None, tok.convert_tokens_to_ids("<|facial|>"), tok)[0]
    stacked = dict(encoded["stacked"])
    stacked["face_pixels"] = np.zeros_like(stacked["face_pixels"])
    stacked["clean_ids"] = np.tile(null_ids.astype(np.int32), (N_ITEMS, 1))
    _, _, null_face, _, null_prompt = encoded["encode"](
        encoded["params"], stacked["images"], stacked["face_pixels"],
        stacked["region_pixels"], stacked["clean_ids"])
    with np.load(root / "enc" / "shared.npz") as sh:
        for key, w in (("null_face_embeds", null_face),
                       ("null_prompt_embeds", null_prompt)):
            assert rel_l2(torch.from_numpy(unpack_float(sh[key])),
                          torch.from_numpy(np.array(w[0]))) <= 1e-5, key
        assert not sh["null_facial_idx_mask"].any()


def test_encoded_dataset_matches_jax(encoded):
    """JAX's EncodedFGIDDataset and the port's on the port's cache, one
    seed, 30% dropout per branch: the same branch per draw and the same
    arrays, item by item and in shuffled batches."""
    path = encoded["path"]
    kw = dict(text_drop_prob=0.3, seed=5)
    jds = jax_precompute.EncodedFGIDDataset(path, **kw)
    pds = EncodedFGIDDataset(path, **kw)
    np.testing.assert_array_equal(pds.null_prompt, jds.null_prompt)
    branches = set()
    for i in list(range(N_ITEMS)) * 4:
        want, got = jds[i], pds[i]
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        text = np.array_equal(got["prompt_embeds"], pds.null_prompt)
        image = np.array_equal(got["face_embeds"], pds.null_face)
        branches.add((text, image))
    assert branches == {(False, False), (True, False), (True, True)}
    for got, want in zip(pds.batches(2, epochs=2), jds.batches(2, epochs=2)):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
