"""The port's W8A8 int8 UNet against the JAX package's on the CPU, fp32:
the quantizers, the two int8 products, the Int8Conv/Int8Dense layers, the
folded int8 UNet (dynamic and calibrated static), calibrate_int8's scale
tree, the act-scales `.npz` in both directions, with_quant, generate end to
end, the tiny SDXL int8 UNet, and the int8 UNet reaching every serving
pipeline. SDXL's calibration is in tests/test_torch_quant_sdxl.py.

Tolerances:
  - quantizers: int8 codes and fp32 scales bit for bit (the same fp32
    division and round-half-even on both sides);
  - one int8 layer on the same input: rtol 1e-6 (the integer product is
    exact; the epilogue is the same fp32 arithmetic);
  - whole networks: dynamic quantization is discontinuous. A last-bit
    difference of a float layer upstream (GroupNorm, softmax) moves an
    activation across a .5 boundary and flips its code, and the per-token
    scales of the next layers spread that: run freely, the port's and
    JAX's tiny UNets differ by several per cent, about as much as int8
    noise against the float UNet. So the network comparisons share JAX's
    codes (`CodeTape`): JAX's quantizers record their codes in call order,
    and the port's quantize their own input, count where their codes
    differ from JAX's, and go on with JAX's. Scales, products, epilogues
    and every float layer stay the port's own. Held: every code within one
    of JAX's, fewer than 1 in 1000 differing (each a float-rounding tie at
    a .5 boundary); the UNet outputs within 1e-5 relative L2 (fp32
    summation order); the calibrated scale tree within rtol 1e-5; images
    within 1e-3.
The network is a two-level UNet in the tiny bundle, attention on its
second level and in the middle block only, as SDXL's first level has none:
every quantized layer kind (resnet convolutions with a 1x1 shortcut,
stride-2 downsampling, upsampling, 1x1 transformer projections, attention
with LoRA folded and the IP branch, GEGLU) at a smaller graph than
attention on both levels, since compiling the JAX references is most of
this file's time; and a two-level SDXL UNet. Each JAX function is jitted
once, in module-scope fixtures.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from consistentid_tpu.core import PipelineConfig as JaxPipelineConfig
from consistentid_tpu.core import UNetConfig as JaxUNetConfig
from consistentid_tpu.io import quant_scales as jax_scales
from consistentid_tpu.models import layers as jax_layers
from consistentid_tpu.models import unet as jax_unet
from consistentid_tpu.ops import quant as jax_quant
from consistentid_tpu.pipelines import ConsistentIDPipeline as JaxPipeline
from consistentid_tpu.testing import synthetic_clip_tokenizer as jax_tokenizer
from consistentid_tpu.testing import tiny_bundle as jax_tiny_bundle
from consistentid_torch.core import PipelineConfig, UNetConfig
from consistentid_torch.io import params_from_jax
from consistentid_torch.io.from_jax import tree_from_module
from consistentid_torch.models import UNet
from consistentid_torch.io import quant_scales as port_scales
from consistentid_torch.models import layers as port_layers
from consistentid_torch.ops import quant as port_quant
from consistentid_torch.pipelines import ConsistentIDPipeline, SD15Bundle
from consistentid_torch.testing import synthetic_clip_tokenizer, tiny_bundle
from consistentid_torch.utils.image import resize_bicubic_uint8
from test_torch_loading import one_torch_thread  # noqa: F401

PROMPT = "portrait photo of a man with a strong face, blue eyes and a nose"
SIZE, STEPS, MERGE = 64, 3, 1
SMALL_UNET = dict(block_out_channels=(32, 64), layers_per_block=1,
                  down_block_has_attn=(False, True),
                  num_attention_heads=(2, 2), cross_attention_dim=64,
                  norm_num_groups=8, lora_rank=4, ip_num_tokens=4)
SMALL_SDXL_UNET = dict(
    block_out_channels=(32, 64), layers_per_block=1,
    down_block_has_attn=(False, True), transformer_layers_per_block=(0, 2),
    mid_transformer_depth=1, num_attention_heads=(2, 2),
    cross_attention_dim=96, norm_num_groups=8,
    addition_embed_type="text_time", addition_time_embed_dim=8,
    projection_class_embeddings_input_dim=8 * 6 + 64)
FLIP_SHARE = 1e-3


def _draw(shapes, seed):
    """Numpy parameters in a flax tree's shapes (arrays or shape structs):
    kernels ~ N(0, 1/fan_in), norm scales ~ 1 + N(0, 0.1), the rest
    ~ N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            fan_in = int(np.prod(x.shape[:-1]))
            return (rng.standard_normal(x.shape, np.float32)
                    / np.float32(np.sqrt(fan_in)))
        if "scale" in name:
            return 1.0 + 0.1 * rng.standard_normal(x.shape, np.float32)
        return 0.1 * rng.standard_normal(x.shape, np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _face(h=72, w=80):
    """A seeded face of another size than the 64 px generation (so the
    calibration's PIL BICUBIC resize runs) with its parsing labels."""
    rng = np.random.RandomState(3)
    face = rng.randint(0, 255, (h, w, 3), np.uint8)
    labels = np.zeros((h, w), np.uint8)
    labels[10:60, 10:70] = 1
    labels[18:24, 18:30] = 4
    labels[18:24, 44:56] = 5
    labels[30:38, 34:42] = 10
    labels[44:50, 28:50] = 12
    return face, labels, rng.randn(1, 16).astype(np.float32)


# ------------------------------------------------------------- code tape

class CodeTape:
    """JAX's activation codes in call order, fed to the port's int8
    layers in place of their own (module docstring). `record` is the
    callback the JAX quantizers call; `forcing()` patches the port's."""

    def __init__(self):
        self.codes = []
        self.flips = self.total = self.max_diff = self.used = 0

    def record(self, q):
        self.codes.append(np.array(q))

    def clear(self):
        self.__init__()

    def _next(self, own: torch.Tensor) -> torch.Tensor:
        want = self.codes[self.used]
        self.used += 1
        if own.dim() == 4:      # the port's NCHW against JAX's NHWC
            want = want.transpose(0, 3, 1, 2)
        want = torch.from_numpy(np.ascontiguousarray(want))
        assert want.shape == own.shape, (want.shape, own.shape)
        diff = (want.int() - own.int()).abs()
        self.flips += int((diff > 0).sum())
        self.total += diff.numel()
        self.max_diff = max(self.max_diff, int(diff.max()))
        return want

    def forcing(self, mp):
        sym, fixed = (port_layers.quantize_symmetric,
                      port_layers.quantize_with_scale)

        def quantize_symmetric(x, dims, keepdim=False):
            q, s = sym(x, dims, keepdim)
            return self._next(q), s

        mp.setattr(port_layers, "quantize_symmetric", quantize_symmetric)
        mp.setattr(port_layers, "quantize_with_scale",
                   lambda x, s: self._next(fixed(x, s)))

    def check(self):
        """Every recorded code used; the port's own within one of JAX's,
        fewer than FLIP_SHARE of them differing."""
        assert self.used == len(self.codes) and self.used > 0
        assert self.max_diff <= 1, self.max_diff
        assert self.flips <= FLIP_SHARE * self.total, (self.flips,
                                                       self.total)


@pytest.fixture(scope="module")
def tape():
    """The JAX layers' quantizers record their codes into one tape (an
    ordered callback, so jitted functions traced here record too)."""
    tape = CodeTape()
    sym, fixed = jax_layers.quantize_symmetric, jax_layers.quantize_with_scale

    def quantize_symmetric(x, axis, keepdims=False):
        q, s = sym(x, axis, keepdims)
        jax.debug.callback(tape.record, q, ordered=True)
        return q, s

    def quantize_with_scale(x, s):
        q = fixed(x, s)
        jax.debug.callback(tape.record, q, ordered=True)
        return q

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_layers, "quantize_symmetric", quantize_symmetric)
        mp.setattr(jax_layers, "quantize_with_scale", quantize_with_scale)
        yield tape


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# ------------------------------------------------------------- quantizers

@pytest.mark.parametrize("case", ["conv_activation", "token_activation",
                                  "ties", "zeros"])
def test_quantize_symmetric_matches_jax(case):
    """Codes and scales bit for bit: per example over (C, H, W) of an NCHW
    activation (JAX: over (H, W, C) of NHWC), per token over the last
    axis, exact .5 ties (round half to even), an all-zero input (the 1e-8
    floor)."""
    rng = np.random.default_rng(0)
    if case == "conv_activation":
        x = rng.standard_normal((3, 5, 6, 7), np.float32) * [[[[4.0]]], [[[
            0.01]]], [[[1.0]]]]
        want = jax_quant.quantize_symmetric(jnp.asarray(x), (1, 2, 3),
                                            keepdims=True)
        got = port_quant.quantize_symmetric(
            torch.from_numpy(x).permute(0, 3, 1, 2), (1, 2, 3), keepdim=True)
        got = (got[0].permute(0, 2, 3, 1), got[1].permute(0, 2, 3, 1))
    else:
        x = {"token_activation": rng.standard_normal((2, 9, 40), np.float32),
             "ties": np.array([[127.0, 0.5, 1.5, 2.5, -2.5, -3.5, 126.5,
                                -127.0]], np.float32),
             "zeros": np.zeros((2, 8), np.float32)}[case]
        want = jax_quant.quantize_symmetric(jnp.asarray(x), (x.ndim - 1,),
                                            keepdims=True)
        got = port_quant.quantize_symmetric(torch.from_numpy(x),
                                            (x.ndim - 1,), keepdim=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0].dtype == torch.int8 and got[1].dtype == torch.float32
    if case == "ties":
        np.testing.assert_array_equal(got[0].numpy(),
                                      [[127, 0, 2, 2, -2, -4, 126, -127]])


@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_kernel_quantizers_match_jax(kind):
    """Per-output-channel kernel codes and scales bit for bit: OIHW over
    (1, 2, 3) against HWIO over (0, 1, 2); (O, I) over 1 against (I, O)
    over 0."""
    rng = np.random.default_rng(1)
    if kind == "conv":
        w = rng.standard_normal((3, 3, 24, 40), np.float32)
        jq, js = jax_quant.quantize_conv_kernel(jnp.asarray(w))
        pq, ps = port_quant.quantize_conv_kernel(
            torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
        pq = pq.permute(2, 3, 1, 0)
    else:
        w = rng.standard_normal((48, 24), np.float32)
        jq, js = jax_quant.quantize_dense_kernel(jnp.asarray(w))
        pq, ps = port_quant.quantize_dense_kernel(torch.from_numpy(w.T.copy()))
        pq = pq.t()
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


def test_int_mm_plain_is_exact():
    """The plain integer product against numpy's int64 one, at the
    largest reduction an SD1.5 layer has (3x3x1280 = 11520) and all codes
    at +-127, where float32 would round."""
    rng = np.random.default_rng(2)
    a = rng.choice([-127, 127], (19, 11520)).astype(np.int8)
    b = rng.choice([-127, 127], (11520, 16)).astype(np.int8)
    got = port_quant.int_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


# ------------------------------------------------------------- layers

LAYERS = {   # name: (JAX module kwargs, input shape NHWC or (B, S, C))
    "conv3x3": (dict(kernel_size=(3, 3), padding=1), (2, 9, 7, 16)),
    "conv3x3_stride2": (dict(kernel_size=(3, 3), strides=(2, 2), padding=1),
                        (2, 9, 8, 16)),
    "conv1x1": (dict(kernel_size=(1, 1), padding=0), (2, 5, 6, 16)),
    "dense": ({}, (2, 7, 16)),
}


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("name", list(LAYERS))
def test_int8_layer_matches_jax(name, static):
    """Int8Conv / Int8Dense against JAX's on the same input and the same
    quantized parameters (carried by params_from_jax: kernel_q HWIO ->
    OIHW, (I, O) -> (O, I)): rtol 1e-6; the dynamic layer's calibration
    record (max(xscale) * 127) bit for bit."""
    kwargs, shape = LAYERS[name]
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape, np.float32)
    conv = name.startswith("conv")
    features = 24
    if conv:
        w = rng.standard_normal((*kwargs["kernel_size"], 16, features),
                                np.float32)
        kq, ks = jax_quant.quantize_conv_kernel(jnp.asarray(w))
        mod = jax_layers.Int8Conv(features, static_act=static, **kwargs)
    else:
        w = rng.standard_normal((16, features), np.float32)
        kq, ks = jax_quant.quantize_dense_kernel(jnp.asarray(w))
        mod = jax_layers.Int8Dense(features, static_act=static)
    params = {"kernel_q": np.asarray(kq), "kernel_scale": np.asarray(ks),
              "bias": 0.1 * rng.standard_normal(features, np.float32)}
    if static:
        params["act_scale"] = np.float32(np.abs(x).max() * 0.8 / 127)
    want, sown = mod.apply({"params": params}, jnp.asarray(x),
                           mutable=["calib"])
    if conv:
        k = kwargs["kernel_size"][0]
        port = port_layers.Int8Conv(16, features, k,
                                    stride=kwargs.get("strides", (1, 1))[0],
                                    padding=kwargs["padding"], static=static)
        xin = torch.from_numpy(x).permute(0, 3, 1, 2)
    else:
        port = port_layers.Int8Dense(16, features, static=static)
        xin = torch.from_numpy(x)
    port.load_state_dict(params_from_jax(params), strict=True)
    port.path = "layer"
    with port_layers.calibration(port) as records:
        got = port(xin)
    if conv:
        got = got.permute(0, 2, 3, 1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    if static:
        assert not records and not sown
    else:
        np.testing.assert_array_equal(
            records["layer"][0].numpy(),
            np.asarray(sown["calib"]["act_amax"][0]))


def test_scale_trees_match_jax():
    """act_scales_from_calib (max over applies, margin, floor, /127) and
    merge_act_scales (elementwise max) on the same records: bit for bit,
    keyed by the same module paths."""
    rng = np.random.default_rng(4)
    paths = ["down_0_resnet_0.conv1", "mid_attn.blocks_0.attn2.to_k",
             "up_1_upsample.conv"]
    trees = []
    for _ in range(2):
        records = {p: [np.float32(v) for v in rng.uniform(0.1, 9, 3)]
                   for p in paths}
        jtree = {}
        for p, vals in records.items():
            node = jtree
            for part in p.split("."):
                node = node.setdefault(part, {})
            node["act_amax"] = tuple(jnp.asarray(v) for v in vals)
        want = jax_quant.act_scales_from_calib(jtree, 1.1)
        got = port_quant.act_scales_from_calib(
            {p: [torch.tensor(v) for v in vals]
             for p, vals in records.items()}, 1.1)
        trees.append((want, got))
        _assert_trees_equal(port_quant.act_scales_to_numpy(got), want)
    _assert_trees_equal(
        port_quant.act_scales_to_numpy(port_quant.merge_act_scales(
            [t[1] for t in trees])),
        jax_quant.merge_act_scales([t[0] for t in trees]))


def _assert_trees_equal(got, want, rtol=0.0):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], rtol)
        else:
            np.testing.assert_allclose(np.asarray(got[k]),
                                       np.asarray(want[k]), rtol=rtol,
                                       atol=0, err_msg=k)


def test_resize_bicubic_pil_is_pil():
    """The bicubic resize (the calibration's face resize, CLIP's, the
    safety checker's), bit for bit with PIL's BICUBIC: down, up, down by
    more than 4 (windows of more than 8 weights, summed in PIL's order),
    one axis only, and a grey (H, W) mask."""
    face, labels, _ = _face()
    big = np.random.RandomState(5).randint(0, 255, (400, 300, 3), np.uint8)
    for img, h, w in ((face, 64, 64), (face, 96, 40), (big, 70, 50),
                      (big, 400, 123), (labels * 20, 33, 150)):
        np.testing.assert_array_equal(
            resize_bicubic_uint8(img, h, w),
            np.asarray(Image.fromarray(img).resize((w, h), Image.BICUBIC)))


# ------------------------------------------------------------- pipelines

@pytest.fixture(scope="module")
def pipes(tape):
    """The JAX and the port SD1.5 pipelines on one set of parameters: the
    tiny bundle with the two-level UNet."""
    jbundle = dataclasses.replace(
        jax_tiny_bundle(), unet_config=JaxUNetConfig(**SMALL_UNET))
    base = tiny_bundle(device="cpu")
    pbundle = SD15Bundle(UNetConfig(**SMALL_UNET), base.adapter_config,
                         base.vae_config, base.text_config,
                         base.vision_config, device="cpu")
    params = _draw(tree_from_module(pbundle)[0], 0)
    pbundle.load_state_dict(params_from_jax(params), strict=True)
    config = dict(height=SIZE, width=SIZE, num_inference_steps=STEPS,
                  start_merge_step=MERGE)
    jpipe = JaxPipeline(jbundle, params, jax_tokenizer(),
                        pipeline_config=JaxPipelineConfig(**config))
    ppipe = ConsistentIDPipeline(pbundle, synthetic_clip_tokenizer(),
                                 pipeline_config=PipelineConfig(**config))
    return jpipe, params, ppipe


@pytest.fixture(scope="module")
def calibrated(pipes, tape):
    """JAX's calibrate_int8 (2 steps; its noise, contexts and codes
    recorded) and the port's on the same face, prompt and noise, with
    JAX's codes and contexts."""
    jpipe, _, ppipe = pipes
    face, labels, faceid = _face()
    kw = dict(num_calib_steps=2, seed=5, margin=1.1, lora_scale=0.8,
              parsing_labels=labels, faceid_embeds=faceid)
    tape.clear()
    contexts = []
    jax_batch = jpipe._calibration_batch

    def keep_contexts(params, cond):
        ctx, added = jax_batch(params, cond)
        jax.debug.callback(lambda c: contexts.append(np.array(c)), ctx)
        return ctx, added

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe, "_calibration_batch", keep_contexts)
        jstatic = jpipe.calibrate_int8(PROMPT, Image.fromarray(face), **kw)
    key = jax.random.PRNGKey(5)
    noise = []
    for _ in range(2):       # JAX's draws: split, then normal(key)
        key, k = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(k, (1, SIZE // 2,
                                                      SIZE // 2, 4))))
    port_batch = ppipe._calibration_batch

    def jax_contexts(cond):
        """The port's contexts near JAX's (fp32 towers, summation order
        only: 1e-4), then JAX's, so that the towers' last bits do not
        reach the scales."""
        ctx, added = port_batch(cond)
        np.testing.assert_allclose(ctx.numpy(), contexts[0], rtol=0,
                                   atol=1e-4)
        return torch.from_numpy(contexts[0]), added

    with pytest.MonkeyPatch.context() as mp:
        tape.forcing(mp)
        mp.setattr(ppipe, "_calibration_batch", jax_contexts)
        pstatic = ppipe.calibrate_int8(PROMPT, face, noise=noise, **kw)
    tape.check()
    return jstatic, pstatic


def test_calibrate_int8_matches_jax(calibrated):
    """The scale tree at rtol 1e-5, over every quantized layer of the
    UNet, keyed by JAX's module paths."""
    jstatic, pstatic = calibrated
    assert pstatic.bundle.quant == "int8_static"
    _assert_trees_equal(pstatic.bundle.act_scales,
                        jax.device_get(jstatic.bundle.act_scales), rtol=1e-5)


def _unet_inputs():
    rng = np.random.default_rng(6)
    return (rng.standard_normal((3, 16, 16, 4), np.float32),
            np.array([900.0, 500.0, 20.0], np.float32),
            rng.standard_normal((3, 81, 64), np.float32))


@pytest.fixture(scope="module")
def jax_unet_fns(pipes, calibrated, tape):
    """JAX's folded int8 UNet (infer_unet at lora_scale 0.8, inside the
    jit as generate runs it) on `_unet_inputs`, dynamic, and static as a
    function of its scale tree: one jitted function each."""
    jpipe, params, _ = pipes
    x, t, ctx = _unet_inputs()
    scales = jax.device_get(calibrated[0].bundle.act_scales)
    dyn = dataclasses.replace(jpipe.bundle, quant="int8")
    static = dataclasses.replace(jpipe.bundle, quant="int8_static",
                                 act_scales=scales)
    dyn_fn = jax.jit(lambda p: dyn.unet_infer.apply(
        {"params": dyn.infer_unet(p, 0.8)[1]}, x, t, ctx))
    static_fn = jax.jit(lambda p, s: static.unet_infer.apply(
        {"params": dataclasses.replace(static, act_scales=s).infer_unet(
            p, 0.8)[1]}, x, t, ctx))
    return (lambda: np.asarray(dyn_fn(params["unet"])),
            lambda tree: np.asarray(static_fn(params["unet"], tree)), scales)


@pytest.mark.parametrize("quant", ["int8", "int8_static"])
def test_int8_unet_matches_jax(pipes, jax_unet_fns, tape, quant):
    """The folded int8 UNet (LoRA at 0.8, then quantized, once per call)
    against JAX's infer_unet + apply: relative L2 1e-5 with JAX's codes
    shared (module docstring), the port's own codes within one of them."""
    _, _, ppipe = pipes
    dyn_fn, static_fn, scales = jax_unet_fns
    x, t, ctx = _unet_inputs()
    tape.clear()
    if quant == "int8":
        want = dyn_fn()
        bundle = ppipe.bundle.quantized("int8")
    else:
        want = static_fn(scales)
        bundle = ppipe.bundle.quantized("int8_static", scales)
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        tape.forcing(mp)
        unet = bundle.infer_unet(0.8)
        assert unet.quant == {"int8": True, "int8_static": "static"}[quant]
        got = unet(torch.from_numpy(x), torch.from_numpy(t),
                   torch.from_numpy(ctx))
    tape.check()
    assert _rel(got, want) <= 1e-5


def test_act_scales_files_cross_load(pipes, jax_unet_fns, tape, tmp_path):
    """A JAX-written .npz loaded by the port serves the same static UNet
    output as the port's own scales, and a port-written one loaded by JAX
    the same JAX output as JAX's own: the trees bit for bit, the outputs
    identical."""
    _, _, ppipe = pipes
    _, static_fn, scales = jax_unet_fns
    x, t, ctx = _unet_inputs()
    jax_file, port_file = str(tmp_path / "jax.npz"), str(tmp_path / "p.npz")
    jax_scales.save_act_scales(jax_file, scales)
    from_jax = port_scales.load_act_scales(jax_file)
    _assert_trees_equal(from_jax, scales)
    port_scales.save_act_scales(port_file, from_jax)
    from_port = jax_scales.load_act_scales(port_file)
    _assert_trees_equal(from_port, scales)
    tape.clear()
    np.testing.assert_array_equal(static_fn(from_port), static_fn(scales))
    outs = []
    for tree in (scales, from_jax):
        with torch.no_grad():
            unet = ppipe.bundle.quantized("int8_static", tree).infer_unet(0.8)
            outs.append(unet(torch.from_numpy(x), torch.from_numpy(t),
                             torch.from_numpy(ctx)).numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    with pytest.raises(ValueError, match="not an act-scales artifact"):
        np.savez(str(tmp_path / "foreign.npz"), w=np.ones(3))
        port_scales.load_act_scales(str(tmp_path / "foreign.npz"))


def test_quant_modes_are_checked(pipes):
    """As JAX's bundle: int8_static without scales, or an unknown mode,
    raises; a twin shares the parameters; calibrated scales carry over to
    a later with_quant("int8_static")."""
    _, _, ppipe = pipes
    with pytest.raises(ValueError, match="act_scales"):
        ppipe.with_quant("int8_static")
    with pytest.raises(ValueError, match="quant must be one of"):
        ppipe.with_quant("int4")
    twin = ppipe.with_quant("int8")
    assert twin.bundle.unet is ppipe.bundle.unet
    assert ppipe.bundle.quant == "none" and twin.bundle.quant == "int8"
    unet, vae = ppipe.bundle.unet, ppipe.bundle.vae
    twin.bundle.unet = torch.nn.Identity()    # the twin's registry only
    ppipe.bundle.vae = torch.nn.Identity()    # the original's only
    assert ppipe.bundle.unet is unet and twin.bundle.vae is vae
    ppipe.bundle.vae = vae
    scales = {"down_0_resnet_0": {"conv1": {"act_scale": np.float32(0.1)}}}
    back = ppipe.with_quant("int8_static", scales).with_quant(
        "none").with_quant("int8_static")
    assert back.bundle.act_scales is scales
    with pytest.raises(ValueError, match="down_0_resnet_0.conv2"):
        back.bundle.infer_unet(1.0)       # a layer without its scale


@pytest.mark.parametrize("quant", ["int8", "int8_static"])
def test_generate_matches_jax(pipes, calibrated, tape, quant):
    """generate's core end to end (encode, fold + quantize, 3 DDIM steps
    with the merge switch, decode) against JAX's on injected latents, JAX's
    codes shared: images within 1e-3 (as the float pipeline test); the
    stages include the fold."""
    jpipe, params, ppipe = pipes
    jstatic, _ = calibrated
    face, labels, faceid = _face(SIZE, SIZE)
    jp = jpipe.with_quant("int8") if quant == "int8" else jstatic
    jcond = jp.prepare_conditioning(PROMPT, Image.fromarray(face),
                                    parsing_labels=labels,
                                    faceid_embeds=faceid)
    latents = np.random.default_rng(7).standard_normal(
        (1, SIZE // 2, SIZE // 2, 4), np.float32)
    tape.clear()
    want = np.asarray(jp._core_jit(
        params, jp._device_cond(jcond), jnp.asarray(latents),
        jnp.float32(5.0), jnp.int32(MERGE), STEPS, "ddim", jnp.float32(1.0),
        jnp.float32(0.8), jax.random.PRNGKey(1), 1))
    pp = ppipe.with_quant(quant, jax.device_get(jstatic.bundle.act_scales)
                          if quant == "int8_static" else None)
    pcond = pp.prepare_conditioning(PROMPT, face, parsing_labels=labels,
                                    faceid_embeds=faceid)
    with pytest.MonkeyPatch.context() as mp:
        tape.forcing(mp)
        got = pp._generate_core(pp.device_cond(pcond),
                                torch.from_numpy(latents), 5.0, MERGE, STEPS,
                                "ddim", 1.0, 0.8)
    tape.check()
    assert list(pp.last_stage_ms) == ["encode", "fold", "denoise", "decode"]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_sdxl_int8_unet_matches_jax(tape):
    """The SDXL layout's int8 UNet (text_time embedding, linear transformer
    projections, depth-2 transformer, a level without attention):
    quantize_state_like against quantize_params_like on the same float
    parameters, then the dynamic UNet at relative L2 1e-5 with JAX's codes
    shared."""
    cfg = JaxUNetConfig(**SMALL_SDXL_UNET)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 8, 8, 4), np.float32)
    t = np.array([700.0, 30.0], np.float32)
    ctx = rng.standard_normal((2, 13, 96), np.float32)
    added = {"text_embeds": rng.standard_normal((2, 64), np.float32),
             "time_ids": np.tile(np.array([[64, 64, 0, 0, 64, 64]],
                                          np.float32), (2, 1))}
    args = (x, jnp.asarray(t), ctx)
    params = _draw(tree_from_module(UNet(UNetConfig(**SMALL_SDXL_UNET)))[0],
                   9)
    qmod = jax_unet.UNet(cfg, quant=True)
    struct = jax.eval_shape(qmod.init, jax.random.PRNGKey(0), *args,
                            added_cond=added)["params"]
    qparams = jax_quant.quantize_params_like(struct, params)
    tape.clear()
    want = np.asarray(jax.jit(lambda p, *a, **k: qmod.apply(
        {"params": p}, *a, **k))(qparams, *args, added_cond=added))
    with torch.device("meta"):
        port = UNet(UNetConfig(**SMALL_SDXL_UNET), quant=True)
    state = port_quant.quantize_state_like(port.state_dict(),
                                           params_from_jax(params))
    for k, v in params_from_jax(qparams).items():
        assert torch.equal(state[k], v), k
    port.load_state_dict(state, assign=True)
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        tape.forcing(mp)
        got = port(torch.from_numpy(x), torch.from_numpy(t),
                   torch.from_numpy(ctx),
                   added_cond={k: torch.from_numpy(v)
                               for k, v in added.items()})
    tape.check()
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("path", ["img2img", "inpaint", "controlnet_inpaint",
                                  "deepcache"])
def test_int8_reaches_every_pipeline(pipes, path):
    """The bundle's int8 mode reaches the UNet of each serving pipeline
    through infer_unet: calibrating the UNet it builds, every int8 layer
    records its input at each of the 2 steps (DeepCache at interval 2: the
    full first step all of them, the cached second the level-0 and last
    up blocks again), and nothing else records (the ControlNet stays
    float, as in JAX)."""
    from consistentid_torch.pipelines import (
        ConsistentIDControlNetInpaintPipeline, ConsistentIDImg2ImgPipeline,
        ConsistentIDInpaintPipeline)
    from consistentid_torch.testing import tiny_controlnet

    _, _, ppipe = pipes
    bundle = ppipe.bundle.quantized("int8")
    face, labels, faceid = _face(SIZE, SIZE)
    init = np.random.RandomState(4).randint(0, 255, (SIZE, SIZE, 3),
                                            np.uint8)
    mask = np.zeros((SIZE, SIZE), np.uint8)
    mask[16:48, 16:48] = 255
    cls, args, extra = {
        "img2img": (ConsistentIDImg2ImgPipeline, (init,), {}),
        "inpaint": (ConsistentIDInpaintPipeline, (init, mask), {}),
        "controlnet_inpaint": (
            ConsistentIDControlNetInpaintPipeline, (init, mask),
            dict(controlnet=tiny_controlnet(bundle.unet_config,
                                            device="cpu"))),
        "deepcache": (ConsistentIDPipeline, (), {})}[path]
    pipe = cls(bundle, synthetic_clip_tokenizer(), pipeline_config=(
        PipelineConfig(height=SIZE, width=SIZE, num_inference_steps=2,
                       start_merge_step=1)), **extra)
    kw = dict(parsing_labels=labels, faceid_embeds=faceid)
    if path == "deepcache":
        kw["cache_interval"] = 2
    if path == "controlnet_inpaint":
        kw["control_image"] = init
    if path != "deepcache":
        kw["strength"] = 1.0
    runs = []
    build = bundle.infer_unet
    with contextlib.ExitStack() as stack, torch.no_grad(), \
            pytest.MonkeyPatch.context() as mp:
        def recording(lora_scale):
            unet = build(lora_scale)
            runs.append(stack.enter_context(port_layers.calibration(unet)))
            return unet

        mp.setattr(bundle, "infer_unet", recording)
        pipe.generate(PROMPT, face, *args, **kw)
    assert len(runs) == 1
    records = runs[0]
    unet = build(1.0)
    names = {n for n, m in unet.named_modules()
             if isinstance(m, (port_layers.Int8Conv, port_layers.Int8Dense))}
    assert set(records) == names
    shallow = {n for n in names if n.startswith(
        ("down_0_resnet", "down_0_attn", "up_1_resnet", "up_1_attn"))}
    for name, values in records.items():
        assert len(values) == (2 if path != "deepcache" or name in shallow
                               else 1), name
