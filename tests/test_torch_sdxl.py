"""The PyTorch port's SDXL slice against the JAX package on the CPU: the
tiny SDXL bundle (JAX `testing.tiny_sdxl_bundle`, its VAE set to
force_upcast so the fp32 decode runs), fp32 parameters drawn from a numpy
seed and carried across with params_from_jax, the same host conditioning
and injected latents. Covered: both text towers (penultimate state and
pooled EOS state), the text_time UNet, the tokenizer_2 pad token, the host
conditioning, encode_embeddings_xl, denoise with pooled branches across the
merge step, the full generate core with the fp32 decode, load_sdxl_consistentid
on a set the JAX exporters write, and `apps.infer --sdxl` on the CPU.

Tolerances are those of the SD1.5 parity tests for the same modules: whole
towers and the encode 1e-4 absolute (fp32, summation order only), denoise
with a stand-in UNet 1e-5 relative L2, generate 1e-3 on images in [-1, 1]
(steps and the VAE compound the towers' drift). Each JAX function is jitted
once and shared through module-scope fixtures."""
import dataclasses
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from consistentid_tpu.conditioning import CLIPBPETokenizer as JaxTokenizer
from consistentid_tpu.core import PipelineConfig as JaxPipelineConfig
from consistentid_tpu.core import SchedulerConfig as JaxSchedulerConfig
from consistentid_tpu.io import convert as jax_convert
from consistentid_tpu.io import export_backbones as jax_exp
from consistentid_tpu.pipelines import ConsistentIDXLPipeline as JaxXLPipeline
from consistentid_tpu.pipelines.loading import \
    load_sdxl_consistentid as jax_load_sdxl
from consistentid_tpu.sampling import denoise as jax_denoise
from consistentid_tpu.sampling import schedulers as jax_sched
from consistentid_tpu.sampling.sampler import CondBranch as JaxBranch
from consistentid_tpu.testing import tiny_sdxl_bundle as jax_tiny_sdxl
from consistentid_torch.apps import infer, serve
from consistentid_torch.conditioning import CLIPBPETokenizer
from consistentid_torch.core import PipelineConfig, SchedulerConfig
from consistentid_torch.io import params_from_jax
from consistentid_torch.io.from_jax import tree_from_module
from consistentid_torch.ops import flash_attention as port_flash
from consistentid_torch.pipelines import ConsistentIDXLPipeline
from consistentid_torch.pipelines.loading import load_sdxl_consistentid
from consistentid_torch.sampling import CondBranch, denoise
from consistentid_torch.sampling import schedulers as port_sched
from consistentid_torch.testing import (randomize_perception_module,
                                        synthetic_clip_tokenizer,
                                        tiny_sdxl_bundle)
from consistentid_torch.utils.png import read_image
from test_torch_loading import one_torch_thread  # noqa: F401
from test_torch_pipeline import face_inputs

PROMPT = "portrait photo of a man with a strong face, blue eyes and a nose!"
NEGATIVE = "lowres, blurry"
# 4 steps with the switch after step 2: steps 3 and 4 run the facial branch
STEPS, MERGE, GUIDANCE = 4, 2, 7.5
SIZE = 64


def _vocab():
    """The synthetic byte-level vocab with eos at CLIP's id 49407, where
    the text towers read the pooled state, so prompts get their own pooled
    embeddings."""
    return {**synthetic_clip_tokenizer().encoder, "<|endoftext|>": 49407}


def _draw_params(tree, seed: int):
    """Numpy draws in the shapes of a flax-shaped tree: fan-in normal
    kernels, scales 1 + N(0, 0.1^2), everything else N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def draw(key, x):
        if isinstance(x, dict):
            return {k: draw(k, v) for k, v in x.items()}
        z = rng.standard_normal(x.shape).astype(np.float32)
        if key == "kernel":
            return z / np.sqrt(np.prod(x.shape[:-1]))
        return 1.0 + 0.1 * z if key == "scale" else 0.1 * z

    return draw(None, tree)


@pytest.fixture(scope="module")
def pipes():
    """The JAX and the port pipelines on one set of parameters, drawn in
    the flax tree's shapes (the port bundle's, as io.from_jax maps them),
    with two tokenizers over one vocab, the second padding with "!" (id 0)
    as SDXL's tokenizer_2 dump declares."""
    jbundle = jax_tiny_sdxl()
    jbundle = dataclasses.replace(jbundle, vae_config=dataclasses.replace(
        jbundle.vae_config, force_upcast=True))
    pbundle = tiny_sdxl_bundle(device="cpu", force_upcast=True)
    params = _draw_params(tree_from_module(pbundle)[0], 0)
    pbundle.load_state_dict(params_from_jax(params), strict=True)
    config = dict(height=SIZE, width=SIZE, num_inference_steps=STEPS,
                  start_merge_step=MERGE, guidance_scale=GUIDANCE)
    vocab = _vocab()
    jpipe = JaxXLPipeline(jbundle, params, JaxTokenizer(vocab, []),
                          tokenizer_2=JaxTokenizer(vocab, [], pad_token="!"),
                          pipeline_config=JaxPipelineConfig(**config))
    ppipe = ConsistentIDXLPipeline(
        pbundle, CLIPBPETokenizer(vocab, []),
        tokenizer_2=CLIPBPETokenizer(vocab, [], pad_token="!"),
        pipeline_config=PipelineConfig(**config))
    face, labels, faceid = face_inputs()
    jcond = jpipe.prepare_conditioning(
        PROMPT, Image.fromarray(face), parsing_labels=labels,
        faceid_embeds=faceid, negative_prompt=NEGATIVE)
    return jpipe, params, ppipe, jcond


def test_prepare_conditioning_xl(pipes):
    """Both tokenizers' ids, the trigger indices and time_ids exact (the
    second tokenizer pads with id 0); CLIP pixels within one grey level
    (0.016, as the SD1.5 test)."""
    jpipe, _, ppipe, jcond = pipes
    face, labels, faceid = face_inputs()
    pcond = ppipe.prepare_conditioning(PROMPT, face, parsing_labels=labels,
                                       faceid_embeds=faceid,
                                       negative_prompt=NEGATIVE)
    assert pcond.keys() == jcond.keys()
    for key in ("clean_ids", "text_only_ids", "negative_ids", "clean_ids2",
                "text_only_ids2", "negative_ids2", "facial_idx",
                "facial_idx_mask", "region_masks", "faceid_embeds",
                "time_ids"):
        assert pcond[key].dtype == jcond[key].dtype, key
        np.testing.assert_array_equal(pcond[key], jcond[key], err_msg=key)
    assert (pcond["negative_ids2"] == 0).sum() > 60        # "!" pads
    np.testing.assert_array_equal(pcond["time_ids"],
                                  [[SIZE, SIZE, 0, 0, SIZE, SIZE]])
    for key in ("face_pixels", "region_pixels"):
        np.testing.assert_allclose(pcond[key], jcond[key], rtol=0, atol=0.016,
                                   err_msg=key)


@pytest.mark.parametrize("text", [
    "a photo of a man!", "!! wow!", "portrait <|facial|> of a woman, smiling!",
    ""])
def test_tokenizer_2_pad_token(text, tmp_path):
    """A dump that declares pad_token "!" in tokenizer_config.json: the
    port's from_pretrained against the JAX one, ids and pad id the same; a
    literal "!" is split verbatim to id 0, as HF's special tokens are."""
    vocab = synthetic_clip_tokenizer().encoder
    import json
    with open(tmp_path / "vocab.json", "w") as f:
        json.dump(vocab, f)
    (tmp_path / "merges.txt").write_text("#version: 0.2\n")
    with open(tmp_path / "tokenizer_config.json", "w") as f:
        json.dump({"pad_token": {"content": "!"}}, f)
    got = CLIPBPETokenizer.from_pretrained(str(tmp_path))
    want = JaxTokenizer.from_pretrained(str(tmp_path))
    for t in (got, want):
        t.add_tokens(["<|image|>", "<|facial|>"])
    assert got.pad_token_id == want.pad_token_id == 0
    assert got.encode(text) == want.encode(text)
    assert got.encode("!") == [got.bos_token_id, 0, got.eos_token_id]


def _unet_inputs():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 16, 4), np.float32)
    t = np.array([801.0, 41.0], np.float32)
    ctx = rng.standard_normal((2, 77 + 4, 96), np.float32)
    added = {"text_embeds": rng.standard_normal((2, 64), np.float32),
             "time_ids": np.array([[SIZE, SIZE, 0, 0, SIZE, SIZE],
                                   [96, 80, 8, 4, SIZE, SIZE]], np.float32)}
    return x, t, ctx, added


def _tower_ids():
    ids = np.random.default_rng(4).integers(0, 49406, (2, 77))
    ids[0, 9], ids[1, 30] = 49407, 49407   # EOS: the pooled positions
    return ids


@pytest.fixture(scope="module")
def jax_ref(pipes):
    """The JAX outputs the tests hold the port to, from one jitted function
    (one compile): both text towers' penultimate and pooled states on
    `_tower_ids`, the UNet forward on `_unet_inputs`, encode_embeddings_xl
    and the generate core (4 DDIM steps, 2 images, fp32 decode) from
    injected latents."""
    jpipe, params, _, jcond = pipes
    latents = np.random.default_rng(7).standard_normal(
        (2, SIZE // 2, SIZE // 2, 4), np.float32)
    b = jpipe.bundle

    def ref(p, cond, lat, ids, x, t, ctx, added):
        return {
            tower: getattr(b, tower).apply(
                {"params": p[tower]}, ids, output_hidden_state_index=-2)
            for tower in ("text_encoder", "text_encoder_2")} | {
            "unet": b.unet.apply({"params": p["unet"]}, x, t, ctx, added,
                               lora_scale=0.9, ip_scale=0.8),
            "encode": jpipe.encode_embeddings_xl(p, cond),
            "images": jpipe._generate_core(
                p, cond, lat, jnp.float32(GUIDANCE), jnp.int32(MERGE),
                STEPS, "ddim", jnp.float32(0.8), jnp.float32(0.9),
                jax.random.PRNGKey(1))}

    out = jax.jit(ref)(params, jpipe._device_cond(jcond), latents,
                       _tower_ids(), *_unet_inputs())
    return latents, jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("tower", ["text_encoder", "text_encoder_2"])
def test_text_towers_penultimate_and_pooled(pipes, jax_ref, tower):
    """CLIP-L (quick_gelu) and the bigG-style tower (gelu): the penultimate
    hidden state and the final-layer-normed EOS state, 1e-4."""
    want_h, want_p = jax_ref[1][tower]
    got_h, got_p = getattr(pipes[2].bundle, tower)(
        torch.from_numpy(_tower_ids()), output_hidden_state_index=-2)
    np.testing.assert_allclose(got_h.detach().numpy(), want_h, rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got_p.detach().numpy(), want_p, rtol=0,
                               atol=1e-4)


def test_unet_text_time_forward(pipes, jax_ref):
    """The SDXL UNet (linear projections, a plain level 0, text_time added
    embedding) with LoRA and IP scales: 1e-4, as the SD1.5 UNet test."""
    ppipe = pipes[2]
    x, t, ctx, added = _unet_inputs()
    got = ppipe.bundle.unet(
        torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
        lora_scale=0.9, ip_scale=0.8,
        added_cond={k: torch.from_numpy(v) for k, v in added.items()})
    assert got.shape == (2, 16, 16, 4)
    np.testing.assert_allclose(got.detach().numpy(), jax_ref[1]["unet"],
                               rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="added_cond"):
        ppipe.bundle.unet(torch.from_numpy(x), torch.from_numpy(t),
                          torch.from_numpy(ctx))


def test_encode_embeddings_xl(pipes, jax_ref):
    """Both branches' contexts, nulls and pooled embeddings, 1e-4; the
    negative pooled embedding is one tensor in both branches, the positive
    ones differ."""
    _, _, ppipe, jcond = pipes
    want = jax_ref[1]["encode"]
    got = ppipe.encode_embeddings_xl(ppipe.device_cond(jcond))
    for g, w in zip(got, want):
        for field in ("context", "null", "pooled", "pooled_null"):
            gv, wv = getattr(g, field), np.asarray(getattr(w, field))
            assert gv.shape == wv.shape, field
            np.testing.assert_allclose(gv.numpy(), wv, rtol=0, atol=1e-4,
                                       err_msg=field)
    text, facial = got
    assert text.context.shape == (1, 77 + 4, 96)
    assert text.pooled_null is facial.pooled_null


def _torch_unet(x, t, context, added):
    """A cheap stand-in whose eps depends on the context, the pooled
    embedding and the time ids."""
    shift = (context.mean(dim=(1, 2)) + added["text_embeds"].mean(-1)
             + 1e-3 * added["time_ids"].mean(-1))
    return torch.tanh(0.3 * x + 1e-4 * t[:, None, None, None]
                      + shift[:, None, None, None])


def _jax_unet(x, t, context, added, i):
    shift = (context.mean(axis=(1, 2)) + added["text_embeds"].mean(-1)
             + 1e-3 * added["time_ids"].mean(-1))
    return jnp.tanh(0.3 * x + 1e-4 * t[:, None, None, None]
                    + shift[:, None, None, None])


@pytest.mark.parametrize("name", ["ddim", "euler"])
def test_denoise_pooled_branches(name):
    """denoise with pooled branches past the merge step, against the JAX
    loop: 1e-5 relative L2 (fp32, elementwise order only). The facial
    branch's pooled positive is read after the switch: replacing it with
    the text branch's moves the result by more than ten times that."""
    rng = np.random.default_rng(6)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    lat = f(2, 4, 4, 4)
    text = [f(2, 3, 8), f(2, 3, 8), f(2, 16), f(2, 16)]
    facial = [f(2, 3, 8), f(2, 3, 8), f(2, 16), text[3]]
    time_ids = np.tile(np.float32([[SIZE, SIZE, 0, 0, SIZE, SIZE]]), (2, 1))
    jplan = jax_sched.make_plan(
        jax_sched.NoiseSchedule.create(JaxSchedulerConfig()), name, STEPS)
    want = jax.jit(lambda x, tb, fb, ti: jax_denoise(
        _jax_unet, x, JaxBranch(*tb), JaxBranch(*fb), jplan,
        jnp.float32(GUIDANCE), jnp.int32(MERGE), time_ids=ti))(
        lat, text, facial, time_ids)
    plan = port_sched.make_plan(
        port_sched.NoiseSchedule.create(SchedulerConfig()), name, STEPS)
    t = torch.from_numpy

    def run(fac):
        return denoise(_torch_unet, t(lat), CondBranch(*map(t, text)),
                       CondBranch(*map(t, fac)), plan, GUIDANCE, MERGE,
                       time_ids=t(time_ids)).numpy()

    got = run(facial)
    want = np.asarray(want)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-5
    swapped = run(facial[:2] + [text[2], facial[3]])
    assert np.linalg.norm(swapped - want) / np.linalg.norm(want) > 1e-4


def test_generate_core_xl_fp32_decode(pipes, jax_ref, monkeypatch):
    """Encode, 4 DDIM steps across the merge step and the fp32 decode from
    injected latents (2 images of one request): 1e-3 on images in
    [-1, 1]."""
    _, _, ppipe, jcond = pipes
    latents, want = jax_ref[0], jax_ref[1]["images"]
    decoded = []
    real_vae = ppipe.fp32_vae

    def fp32_vae():
        decoded.append(True)
        return real_vae()

    monkeypatch.setattr(ppipe, "fp32_vae", fp32_vae)
    got = ppipe._generate_core(ppipe.device_cond(jcond),
                               torch.from_numpy(latents), GUIDANCE, MERGE,
                               STEPS, "ddim", 0.8, 0.9)
    assert got.shape == want.shape == (2, SIZE, SIZE, 3)
    assert got.dtype == torch.float32 and decoded == [True]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_fp32_vae_copy_follows_the_weights():
    """A 16-bit VAE decodes through an fp32 copy that is kept while its
    weights stay as they are, and made anew after an in-place edit, a
    reload or a replaced parameter: the copy always equals the cast of the
    current weights, as the JAX package's per-call cast does."""
    bundle = tiny_sdxl_bundle(device="cpu", dtype=torch.bfloat16,
                              force_upcast=True)
    pipe = ConsistentIDXLPipeline(bundle, synthetic_clip_tokenizer())
    vae = bundle.vae

    def assert_cast(copy):
        want = vae.state_dict()
        for key, got in copy.state_dict().items():
            assert got.dtype == torch.float32
            torch.testing.assert_close(got, want[key].float(), rtol=0,
                                       atol=0)

    first = pipe.fp32_vae()
    assert first is not vae and pipe.fp32_vae() is first
    assert_cast(first)
    with torch.no_grad():
        vae.post_quant_conv.weight.mul_(2)
    edited = pipe.fp32_vae()
    assert edited is not first and pipe.fp32_vae() is edited
    assert_cast(edited)
    vae.load_state_dict({k: v * 3 for k, v in vae.state_dict().items()})
    reloaded = pipe.fp32_vae()
    assert reloaded is not edited
    assert_cast(reloaded)
    conv = vae.decoder.conv_in
    conv.weight = torch.nn.Parameter(-conv.weight.detach())
    replaced = pipe.fp32_vae()
    assert replaced is not reloaded
    assert_cast(replaced)


def test_unet_self_attention_reaches_flash(pipes, monkeypatch):
    """At 64 x 64 latents level 1's self-attention has 1024 tokens and
    crosses the flash cutover: its 3 blocks reach flash_attention through
    dot_product_attention (on CPU tensors the plain version, no launch),
    level 2's 256 tokens stay plain."""
    ppipe = pipes[2]
    calls = []
    real = port_flash.flash_attention

    def spy(q, k, v, sm_scale=None):
        calls.append(tuple(q.shape))
        return real(q, k, v, sm_scale)

    monkeypatch.setattr(port_flash, "flash_attention", spy)
    before = port_flash.flash_attention_fwd.launches
    added = {"text_embeds": torch.zeros(2, 64),
             "time_ids": torch.zeros(2, 6)}
    with torch.no_grad():
        ppipe.bundle.unet(torch.zeros(2, 64, 64, 4), torch.ones(2),
                          torch.zeros(2, 81, 96), added_cond=added)
    assert calls == [(2, 2, 1024, 32)] * 3
    assert port_flash.flash_attention_fwd.launches == before


def test_generate_batch_xl(pipes):
    """generate_batch of two requests: uint8 images, and request 0 the
    same as alone (one seed, an ODE sampler), within one grey level."""
    _, _, ppipe, _ = pipes
    face, labels, faceid = face_inputs()
    kw = dict(parsing_labels_list=[labels, labels[:, ::-1].copy()],
              faceid_embeds_list=[faceid, -faceid], num_inference_steps=2,
              height=64, width=64)
    pair = ppipe.generate_batch([PROMPT, "a woman"], [face, face],
                                seeds=[3, 4], **kw)
    alone = ppipe.generate(PROMPT, face, seed=3, parsing_labels=labels,
                           faceid_embeds=faceid, num_inference_steps=2,
                           height=64, width=64)
    assert pair.shape == (2, 64, 64, 3) and pair.dtype == np.uint8
    assert np.abs(pair[0].astype(int) - alone[0]).max() <= 1


# ------------------------------------------------------ loading and infer

@pytest.fixture(scope="module")
def synth(tmp_path_factory, pipes):
    """A tiny SDXL reference-layout set written by the JAX package's
    exporters from the parity tests' parameters: the sdxl/ dump with both
    tokenizers, the image encoder, the ConsistentID .bin under the SDXL
    prefixes, and BiSeNet, ArcFace and SCRFD packs (seeded random port
    modules, exported as the JAX package exports its own)."""
    from safetensors.numpy import save_file

    from consistentid_torch.models.arcface import IResNet
    from consistentid_torch.models.bisenet import BiSeNet
    from consistentid_torch.models.scrfd import SCRFD, SCRFD_VARIANTS

    jpipe, params, _, _ = pipes
    cfg = jpipe.bundle
    root = tmp_path_factory.mktemp("sdxl_set")
    base = root / "sdxl"

    def save_st(rel, sd):
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        save_file({k: np.ascontiguousarray(v, np.float32)
                   for k, v in sd.items()}, str(path))
        return str(path)

    def save_torch(name, sd):
        def tensors(d):
            return {k: tensors(v) if isinstance(v, dict) else
                    torch.from_numpy(np.array(v, np.float32))
                    for k, v in d.items()}
        torch.save(tensors(sd), str(root / name))
        return str(root / name)

    save_st("sdxl/unet/diffusion_pytorch_model.safetensors",
            jax_exp.unet_to_diffusers(params["unet"], cfg.unet_config))
    save_st("sdxl/vae/diffusion_pytorch_model.safetensors",
            jax_exp.vae_to_diffusers(params["vae"], cfg.vae_config))
    for sub, tcfg in (("text_encoder", cfg.text_config),
                      ("text_encoder_2", cfg.text_config_2)):
        save_st(f"sdxl/{sub}/model.safetensors",
                jax_exp.clip_text_to_hf(params[sub], tcfg))
    import json
    for sub, tok_cfg in (("tokenizer", None),
                         ("tokenizer_2", {"pad_token": "!"})):
        (base / sub).mkdir()
        (base / sub / "vocab.json").write_text(json.dumps(_vocab()))
        (base / sub / "merges.txt").write_text("#version: 0.2\n")
        if tok_cfg:
            (base / sub / "tokenizer_config.json").write_text(
                json.dumps(tok_cfg))
    paths = {"base": str(base), "image_encoder": save_st(
        "image_encoder.safetensors", jax_exp.clip_vision_to_hf(
            params["image_encoder"], cfg.vision_config))}
    sd = jax_convert.export_consistentid_checkpoint(
        params, cfg.unet_config, facial_depth=cfg.adapter_config.facial_depth)
    sd["image_proj_model"] = sd.pop("image_proj")
    paths["consistentid"] = save_torch("ConsistentID_SDXL-v1.bin", sd)

    gen = torch.Generator().manual_seed(3)
    iresnet = dict(layers=(1, 1, 1, 1), embedding_dim=16, input_size=32)
    for name, model, export in (
            ("face_parsing.pth", BiSeNet(),
             lambda p, st: jax_exp.bisenet_to_torch(p, st)),
            ("arcface.pt", IResNet(**iresnet),
             lambda p, st: jax_exp.iresnet_to_torch(
                 p, st, layers=iresnet["layers"], spatial=2)),
            ("scrfd.pt", SCRFD(SCRFD_VARIANTS["tiny"]),
             lambda p, st: jax_exp.scrfd_to_torch(
                 p, st, SCRFD_VARIANTS["tiny"]))):
        randomize_perception_module(model, gen)
        flat = ({"fc": model.bn2.num_features} if name == "arcface.pt"
                else None)
        paths[name.split(".")[0]] = save_torch(
            name, export(*tree_from_module(model, flatten_nhwc=flat)))
    return paths


def test_load_sdxl_matches_jax_loader(synth, pipes):
    """Every leaf of the bundle, fp32, exact (the two loaders' init trees
    differ: the JAX bundle's init is replaced by other numpy draws, so
    equality means every leaf came from the files in both), the second
    tokenizer's pad id, the face stack with its detector at 512."""
    kw = dict(consistentid_path=synth["consistentid"],
              image_encoder_path=synth["image_encoder"],
              bisenet_path=synth["face_parsing"],
              arcface_path=synth["arcface"], scrfd_path=synth["scrfd"])
    port = load_sdxl_consistentid(synth["base"],
                                  bundle=tiny_sdxl_bundle(device="cpu"),
                                  device="cpu", **kw)
    jbundle = jax_tiny_sdxl()
    init = _draw_params(tree_from_module(pipes[2].bundle)[0], 1)
    jbundle.init_params = lambda rng, latent_hw=8: init
    want = jax_load_sdxl(synth["base"], bundle=jbundle, dtype=jnp.float32,
                         **kw)
    want_state = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        want.params))
    got_state = port.bundle.state_dict()
    assert set(got_state) == set(want_state)
    for k, w in want_state.items():
        torch.testing.assert_close(got_state[k], w, rtol=0, atol=0, msg=k)
    assert port.tokenizer_2.pad_token_id == want.tokenizer_2.pad_token_id == 0
    assert port.tokenizer.pad_token_id == want.tokenizer.pad_token_id
    assert port.face_parser is not None and port.face_embedder is not None
    assert port.face_embedder.detector.input_size == 512


def test_infer_cli_sdxl_writes_png(synth, tmp_path):
    face = tmp_path / "face.png"
    Image.fromarray(np.random.default_rng(0).integers(
        0, 255, (96, 80, 3), np.uint8)).save(face)
    out = str(tmp_path / "xl.png")
    pipe = infer.main([
        "--sdxl", "--base", synth["base"],
        "--consistentid", synth["consistentid"],
        "--image-encoder", synth["image_encoder"],
        "--bisenet", synth["face_parsing"], "--arcface", synth["arcface"],
        "--image", str(face), "--prompt", "a woman, city at night",
        "--out", out, "--tiny", "--device", "cpu", "--steps", "2",
        "--height", "64", "--width", "48"])
    assert isinstance(pipe, ConsistentIDXLPipeline)
    assert pipe.tokenizer_2.pad_token_id == 0
    img = read_image(out)
    assert img.shape == (64, 48, 3) and img.dtype == np.uint8


@pytest.mark.parametrize("app, flags, message", [
    (infer, ["--sdxl", "--init-image", "x.png"], "SD1.5-only"),
    (serve, ["--sdxl"], "SD1.5 only"),
    (serve, ["--tokenizer-2", "t"], "SD1.5 only")])
def test_sdxl_refusals(app, flags, message, capsys):
    """infer refuses img2img with --sdxl, as the JAX CLI does; the server,
    like the JAX package's, serves no SDXL."""
    with pytest.raises(SystemExit) as exc:
        app.main(["--base", "b", "--image", "f.png", "--prompt", "p",
                  *flags])
    assert exc.value.code == 2
    assert message in capsys.readouterr().err
