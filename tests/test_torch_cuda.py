"""K1-K6 on the card: each CUDA kernel against its plain PyTorch version,
for each dtype and head-dim (K1-K4) or channel-layout (K5, K6)
instantiation, ragged tails included; K5's bits against the plain moments
summed in its order, over repeated calls and on a second stream, and the
device kernels a K5, K6 or fused_bn_act call launches (torch.profiler); the route of K1, K2 and the fused
K3 + K4 (sm90, mma or f32) asserted from the launch counts; the autograd
Function's gradients through the kernels against those through the plain
versions; what the wrappers refuse; two perception networks on the card
against the CPU; the fused backward's bits over repeated calls; the
pipeline's async batch; the tiny SDXL generate on the card against the
CPU; the tiny img2img, inpaint (4- and 9-channel), ControlNet-inpaint and
DeepCache cores on the card against the CPU; the int8 products
(torch._int_mm against the exact integer product, bit for bit, at the int8
UNet's shapes and at m <= 16), the int8 layers and the tiny int8 UNet on
the card against the CPU; PIL's resample on the card against the CPU; the
eval scorers (CLIP-T, FaceSim) and the PhotoMaker encoder on the card
against the CPU, and the validation CLI's tiny self-test on the card; the
tiny LLaVA captioner's ids, int8 and int8-KV decode (torch._int_mm at m =
1) and apps.fgid's mask and faceid stages on the card against the CPU; the
gradio demo's request callback on the tiny bundle, card against CPU.
Needs an NVIDIA GPU and
nvcc; skips elsewhere. Imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import pytest
import torch

from consistentid_torch.ops import flash_attention as port_flash
from consistentid_torch.ops import fused_bn_act as port_bn
from consistentid_torch.testing import (KERNEL_BN_APPLY_REL_L2_16BIT,
                                        KERNEL_BN_APPLY_REL_L2_FP32,
                                        KERNEL_BN_MOMENTS_REL_L2,
                                        KERNEL_REL_L2_16BIT,
                                        KERNEL_REL_L2_FP32,
                                        KERNEL_REL_L2_SAME_PRECISION,
                                        PERCEPTION_REL_L2, drop_last_tile,
                                        moments_in_kernel_order,
                                        moments_without_last_cluster,
                                        randomize_perception_module, rel_l2,
                                        tf32_off, unnormalized_last_channels)


@pytest.fixture
def cuda_generator():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the flash kernel is CUDA only)")
    return torch.Generator("cuda").manual_seed(0)


# bf16/fp16: P is rounded to the input type before P V, as in any
# tensor-core flash kernel, and the output to one ulp: 1e-2 on |o| < 1, and
# the relative L2 error within its limit (_assert_rel_l2).
# fp32: the SIMT path in fp32 throughout, summation order only: 1e-5.
@pytest.mark.cuda
@pytest.mark.parametrize("shape,sk,dtype,atol", [
    ((2, 8, 1024, 80), 1024, torch.bfloat16, 1e-2),
    ((1, 8, 4096, 40), 4096, torch.bfloat16, 1e-2),
    ((2, 3, 1000, 40), 1037, torch.bfloat16, 1e-2),
    ((2, 2, 300, 64), 300, torch.float16, 1e-2),
    ((1, 2, 77, 36), 99, torch.bfloat16, 1e-2),
    ((1, 2, 130, 100), 170, torch.bfloat16, 1e-2),
    ((2, 3, 1000, 40), 1037, torch.float32, 1e-5),
    ((2, 3, 333, 64), 517, torch.float32, 1e-5),
    ((1, 2, 130, 128), 70, torch.float32, 1e-5),
    # the sm90 route's edges: fp16 at full width, Sq and Sk ragged at head
    # dims 80 and 128, Sk under one key tile, one batch*head
    ((1, 8, 4096, 40), 4096, torch.float16, 1e-2),
    ((2, 3, 1000, 80), 1037, torch.float16, 1e-2),
    ((2, 2, 500, 128), 333, torch.bfloat16, 1e-2),
    ((2, 2, 300, 40), 50, torch.bfloat16, 1e-2),
    ((1, 1, 4096, 40), 4096, torch.bfloat16, 1e-2),
    # the infer CLI's default 768x512 at one image: UNet levels 0 and 1
    ((2, 8, 6144, 40), 6144, torch.bfloat16, 1e-2),
    ((2, 8, 1536, 80), 1536, torch.bfloat16, 1e-2),
    # SDXL at 1024x1024, one image: level 1 (X1), level 2 and mid (X2)
    ((2, 10, 4096, 64), 4096, torch.bfloat16, 1e-2),
    ((2, 20, 1024, 64), 1024, torch.bfloat16, 1e-2),
    # img2img / inpaint / ControlNet inpaint at 512 px, one image (CFG
    # pair): UNet (and ControlNet) levels 0 (C0) and 1 (C1)
    ((2, 8, 4096, 40), 4096, torch.bfloat16, 1e-2),
    ((2, 8, 1024, 80), 1024, torch.bfloat16, 1e-2),
])
def test_kernel_matches_plain(cuda_generator, shape, sk, dtype, atol):
    g = cuda_generator
    b, h, sq, d = shape
    q = torch.randn(shape, generator=g, device="cuda").to(dtype)
    k = torch.randn((b, h, sk, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, h, sk, d), generator=g, device="cuda").to(dtype)
    wrapper = port_flash.flash_attention_fwd
    before = wrapper.launches
    routes = dict(wrapper.launches_by_route)
    out = port_flash.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    _assert_one_launch_on(wrapper, routes, _expected_route(dtype, d))
    assert out.dtype == dtype and out.shape == shape
    ref = port_flash.flash_attention_plain(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=atol)
    cut = drop_last_tile(sk)
    _assert_rel_l2(out, ref, dtype, port_flash.flash_attention_plain(
        q, k[:, :, :cut], v[:, :, :cut]))


@pytest.mark.cuda
@pytest.mark.parametrize("lse", [False, True])
def test_misaligned_view_takes_mma_route(cuda_generator, lse):
    """A contiguous q one element into its storage is off 16 bytes, which
    TMA cannot load: K1 and K2 take the mma.sync kernel, by the route
    function and not by a failure, and still match the plain version."""
    shape, sk = (2, 3, 333, 40), 517
    q, k, v, _ = _inputs(cuda_generator, shape, sk, torch.bfloat16)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")
    q = buf[1:].view(shape).copy_(q)
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    assert port_flash.forward_route(q, k, v) == "mma"
    wrapper = (port_flash.flash_attention_lse if lse
               else port_flash.flash_attention_fwd)
    routes = dict(wrapper.launches_by_route)
    out = wrapper(q, k, v)
    torch.cuda.synchronize()
    _assert_one_launch_on(wrapper, routes, "mma")
    ref = port_flash.flash_attention_plain(q, k, v)
    _assert_rel_l2(out[0] if lse else out, ref, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", ["q", "do"])
def test_misaligned_view_takes_mma_backward(cuda_generator, misaligned):
    """A q or dO one element into its storage is off 16 bytes, which TMA
    cannot load: K3 + K4 takes K3's and K4's mma.sync kernels, by the route
    function and not by a failure, and still matches the plain backward."""
    shape, sk = (2, 3, 333, 40), 517
    q, k, v, do = _inputs(cuda_generator, shape, sk, torch.bfloat16)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")
    if misaligned == "q":
        q = buf[1:].view(shape).copy_(q)
    else:
        do = buf[1:].view(shape).copy_(do)
    assert port_flash.backward_route(q, k, v, do) == "mma"
    out, lse = port_flash.flash_attention_lse_plain(q, k, v)
    delta = (do.float() * out.float()).sum(-1)
    wrapper = port_flash.flash_attention_bwd
    routes = dict(wrapper.launches_by_route)
    grads = wrapper(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    _assert_one_launch_on(wrapper, routes, "mma")
    for got, ref in zip(grads, port_flash.flash_attention_bwd_plain(
            q, k, v, do, lse, delta)):
        _assert_rel_l2(got, ref, torch.bfloat16)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_generator):
    q = torch.randn((1, 1, 8, 136), generator=cuda_generator, device="cuda")
    with pytest.raises(ValueError):
        port_flash.flash_attention(q, q, q)
    q = q[..., :64].double()
    with pytest.raises(TypeError):
        port_flash.flash_attention(q, q, q)


BWD_CASES = [
    # shape (B, H, Sq, D), Sk, dtype
    ((2, 8, 1024, 80), 1024, torch.bfloat16),
    # SDXL training at 1024 px, batch 1: T1 (level 1) and T2 (level 2 and
    # the mid block)
    ((1, 10, 4096, 64), 4096, torch.bfloat16),
    ((1, 20, 1024, 64), 1024, torch.bfloat16),
    ((1, 4, 4096, 40), 4096, torch.bfloat16),
    ((2, 3, 1000, 40), 1037, torch.bfloat16),
    ((1, 2, 130, 100), 170, torch.bfloat16),
    ((2, 2, 300, 64), 300, torch.float16),
    ((1, 2, 77, 36), 99, torch.float16),
    ((2, 3, 1000, 40), 1037, torch.float32),
    ((2, 3, 333, 64), 517, torch.float32),
    ((1, 2, 130, 128), 70, torch.float32),
    # the fused sm90 backward's edges: fp16 at head dims 40 and 80, Sq and
    # Sk ragged at 80, 64 and 128, both under one tile, Sq far under Sk and
    # the reverse, one batch*head
    ((2, 4, 1024, 40), 1024, torch.float16),
    ((2, 3, 1000, 80), 1037, torch.float16),
    ((2, 2, 500, 128), 333, torch.bfloat16),
    ((1, 2, 300, 128), 450, torch.float16),
    ((1, 2, 50, 40), 30, torch.bfloat16),
    ((1, 2, 40, 64), 700, torch.float16),
    ((2, 2, 300, 40), 50, torch.bfloat16),
    ((1, 1, 777, 64), 900, torch.bfloat16),
]


# K2 also on the sm90 route's other edges (BWD_CASES hold the backward's)
LSE_CASES = BWD_CASES + [
    ((2, 8, 4096, 40), 4096, torch.float16),
    ((1, 1, 4096, 40), 4096, torch.float16),
]


def _expected_route(dtype, d):
    """The kernel a K1, K2 or K3 + K4 call on 16-byte aligned inputs with the
    default scale must take: sm90 for bf16/fp16 at head dims that are
    multiples of 8, mma for other 16-bit head dims, the SIMT kernels for
    fp32."""
    if dtype == torch.float32:
        return "f32"
    return "sm90" if d % 8 == 0 else "mma"


def _assert_one_launch_on(wrapper, before, route):
    moved = {r: n - before[r] for r, n in wrapper.launches_by_route.items()}
    assert moved == {r: int(r == route) for r in port_flash.ROUTES}, moved


def _inputs(g, shape, sk, dtype):
    b, h, sq, d = shape
    q, k, v, do = (torch.randn(s, generator=g, device="cuda").to(dtype)
                   for s in (shape, (b, h, sk, d), (b, h, sk, d), shape))
    return q, k, v, do


def _assert_rel_l2(got, ref, dtype, control=None, same=None):
    """The kernel's relative L2 error against the plain version within the
    limit of its dtype (consistentid_torch/testing.py: 16-bit inputs round P
    and dS before their products and each output once more; fp32 sums in
    another order only), and the control (the plain version with its last
    key or query tile dropped) above it. `same`: the plain version at the
    kernel's own precision, held to a tighter limit. The absolute bound
    these tests had before stays too."""
    fp32 = dtype == torch.float32
    limit = KERNEL_REL_L2_FP32 if fp32 else KERNEL_REL_L2_16BIT
    assert torch.isfinite(got).all()
    atol = (1e-5 if fp32 else 2e-2) * max(ref.abs().max().item(), 1.0)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=atol)
    assert rel_l2(got, ref) <= limit
    if control is not None:
        assert rel_l2(control, ref) > limit
    if same is not None:
        assert rel_l2(got, same.to(dtype)) <= KERNEL_REL_L2_SAME_PRECISION


@pytest.mark.cuda
@pytest.mark.parametrize("shape,sk,dtype", LSE_CASES)
def test_lse_kernel_matches_plain(cuda_generator, shape, sk, dtype):
    q, k, v, _ = _inputs(cuda_generator, shape, sk, dtype)
    wrapper = port_flash.flash_attention_lse
    before = wrapper.launches
    routes = dict(wrapper.launches_by_route)
    out, lse = port_flash.flash_attention_lse(q, k, v)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    _assert_one_launch_on(wrapper, routes, _expected_route(dtype, shape[3]))
    ref_out, ref_lse = port_flash.flash_attention_lse_plain(q, k, v)
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert lse.shape == shape[:3] and torch.isfinite(lse).all()
    cut = drop_last_tile(sk)
    _assert_rel_l2(out, ref_out, dtype, port_flash.flash_attention_lse_plain(
        q, k[:, :, :cut], v[:, :, :cut])[0])
    # lse from fp32 statistics on both sides; the kernel's exp2 domain and
    # summation order: 1e-4 on values of order log(Sk) + max score
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,sk,dtype", BWD_CASES)
def test_backward_kernels_match_plain(cuda_generator, shape, sk, dtype):
    """K3 + K4 (the fused sm90 kernel, or K3's and K4's mma.sync or SIMT
    kernels) against the plain backward in fp32 and, for 16-bit inputs, at
    its own precision, each output with its dropped-tile control."""
    q, k, v, do = _inputs(cuda_generator, shape, sk, dtype)
    out, lse = port_flash.flash_attention_lse_plain(q, k, v)
    delta = (do.float() * out.float()).sum(-1)
    wrapper = port_flash.flash_attention_bwd
    before = wrapper.launches
    routes = dict(wrapper.launches_by_route)
    dq, dk, dv = wrapper(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    _assert_one_launch_on(wrapper, routes, _expected_route(dtype, shape[3]))
    refs = port_flash.flash_attention_bwd_plain(q, k, v, do, lse, delta)
    same = [None] * 3 if dtype == torch.float32 else \
        port_flash.flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                             round_to=dtype)
    # controls: the last key tile dropped for dq, the last query tile for
    # dk and dv (all of them when Sq is under one tile: zero dk, dv)
    kc, qc = drop_last_tile(sk), drop_last_tile(shape[2])
    controls = [port_flash.flash_attention_bwd_plain(
        q, k[:, :, :kc], v[:, :, :kc], do, lse, delta)[0],
        *(port_flash.flash_attention_bwd_plain(
            q[:, :, :qc], k, v, do[:, :, :qc], lse[:, :, :qc],
            delta[:, :, :qc])[1:] if qc else
          (torch.zeros_like(k, dtype=torch.float32),) * 2)]
    for name, got, ref, ctl, sm in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                       refs, controls, same):
        assert got.dtype == dtype and got.shape == ref.shape, name
        _assert_rel_l2(got, ref, dtype, ctl, sm)


@pytest.mark.cuda
@pytest.mark.parametrize("busy", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 4096, 40), (2, 8, 1024, 80)])
def test_fused_backward_is_deterministic(cuda_generator, shape, busy):
    """dq, dk and dv of the fused sm90 backward the same bits over 50
    calls at the training L0 and L1 (dq's key blocks add as fixed-point
    integers, exact in any order); with `busy`, a second stream runs
    matmuls during the calls, so the CTAs run and finish in other orders."""
    q, k, v, do = _inputs(cuda_generator, shape, shape[2], torch.bfloat16)
    out, lse = port_flash.flash_attention_lse_plain(q, k, v)
    delta = (do.float() * out.float()).sum(-1)
    wrapper = port_flash.flash_attention_bwd
    routes = dict(wrapper.launches_by_route)
    first = wrapper(q, k, v, do, lse, delta)
    _assert_one_launch_on(wrapper, routes, "sm90")
    side = torch.cuda.Stream()
    a = torch.randn(2048, 2048, device="cuda", dtype=torch.bfloat16)
    for _ in range(50):
        if busy:
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(4):
                    a = (a @ a).clamp(-1, 1)
        got = wrapper(q, k, v, do, lse, delta)
        for name, g, f in zip(("dq", "dk", "dv"), got, first):
            assert torch.equal(g, f), name
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_generate_batch_async_matches_generate_batch(cuda_generator):
    """The async variant's callable yields the synchronous batch's uint8
    images (tiny bundle on the card, 3 Euler steps, 64 px)."""
    import numpy as np

    from consistentid_torch.core import PipelineConfig
    from consistentid_torch.pipelines import ConsistentIDPipeline
    from consistentid_torch.testing import (synthetic_clip_tokenizer,
                                            tiny_bundle)

    pipe = ConsistentIDPipeline(
        tiny_bundle(device="cuda"), synthetic_clip_tokenizer(),
        pipeline_config=PipelineConfig(height=64, width=64,
                                       num_inference_steps=3,
                                       start_merge_step=1,
                                       scheduler="euler"))
    rng = np.random.default_rng(0)
    faces = [rng.integers(0, 255, (64, 64, 3), np.uint8) for _ in range(2)]
    labels = [np.zeros((64, 64), np.uint8) for _ in range(2)]
    for lab in labels:
        lab[8:44, 10:50] = 1
        lab[26:31, 28:34] = 10
    embeds = [rng.standard_normal((1, 16)).astype(np.float32)
              for _ in range(2)]
    kw = dict(seeds=[5, 6], parsing_labels_list=labels,
              faceid_embeds_list=embeds)
    prompts = ["a photo of a man", "a photo of a woman"]
    want = pipe.generate_batch(prompts, faces, **kw)
    got = pipe.generate_batch_async(prompts, faces, **kw)()
    assert got.shape == (2, 64, 64, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_tiny_sdxl_generate_card_vs_cpu(cuda_generator):
    """The tiny fp32 SDXL bundle's generate core (4 DDIM steps across the
    merge step at 2, 128 px: level 1's self-attention crosses the flash
    cutover, 3 K1 launches per UNet call on the fp32 route; fp32 decode)
    on the card, TF32 off, against the same bundle on the CPU: the CPU
    parity tests' 1e-3 on images in [-1, 1]."""
    import numpy as np

    from consistentid_torch.core import PipelineConfig
    from consistentid_torch.pipelines import ConsistentIDXLPipeline
    from consistentid_torch.testing import (synthetic_clip_tokenizer,
                                            tiny_sdxl_bundle)

    rng = np.random.default_rng(0)
    face = rng.integers(0, 255, (64, 64, 3), np.uint8)
    labels = np.zeros((64, 64), np.uint8)
    labels[8:44, 10:50] = 1
    labels[26:31, 28:34] = 10
    faceid = rng.standard_normal((1, 16)).astype(np.float32)
    latents = torch.from_numpy(rng.standard_normal((2, 64, 64, 4),
                                                   np.float32))
    cpu = tiny_sdxl_bundle(device="cpu", seed=3, force_upcast=True)
    gpu = tiny_sdxl_bundle(device="cuda", force_upcast=True)
    gpu.load_state_dict(cpu.state_dict())
    wrapper = port_flash.flash_attention_fwd
    outs = []
    with tf32_off():
        for bundle in (cpu, gpu):
            pipe = ConsistentIDXLPipeline(
                bundle, synthetic_clip_tokenizer(),
                pipeline_config=PipelineConfig(height=128, width=128))
            cond = pipe.device_cond(pipe.prepare_conditioning(
                "a photo of a man", face, parsing_labels=labels,
                faceid_embeds=faceid))
            routes = dict(wrapper.launches_by_route)
            img = pipe._generate_core(cond, latents.to(bundle.device), 7.5,
                                      2, 4, "ddim", 1.0, 1.0)
            torch.cuda.synchronize()
            moved = {r: n - routes[r]
                     for r, n in wrapper.launches_by_route.items()}
            outs.append((img.cpu(), moved))
    (cpu_img, cpu_moved), (gpu_img, gpu_moved) = outs
    assert not any(cpu_moved.values())
    assert gpu_moved == {r: 12 * (r == "f32") for r in gpu_moved}
    assert gpu_img.dtype == torch.float32
    torch.testing.assert_close(gpu_img, cpu_img, rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["img2img", "inpaint", "inpaint9",
                                  "controlnet_inpaint", "deepcache"])
def test_tiny_init_image_cores_card_vs_cpu(cuda_generator, path):
    """The tiny fp32 bundle's img2img (strength 0.5), 4- and 9-channel
    inpaint, ControlNet inpaint (guess mode, a keep window) and DeepCache
    (interval 2) cores, 4 DDIM steps at 64 px with injected noise, on the
    card (TF32 off) against the same weights on the CPU: the CPU parity
    tests' 1e-3 on images in [-1, 1]. Level 0's self-attention (1024
    tokens) runs K1 on the fp32 route on the card."""
    import numpy as np

    from consistentid_torch.core import PipelineConfig
    from consistentid_torch.pipelines import (
        ConsistentIDControlNetInpaintPipeline, ConsistentIDImg2ImgPipeline,
        ConsistentIDInpaintPipeline, ConsistentIDPipeline, preprocess_mask)
    from consistentid_torch.testing import (synthetic_clip_tokenizer,
                                            tiny_bundle, tiny_controlnet)
    from consistentid_torch.utils.image import sd_image_preprocess

    rng = np.random.default_rng(0)
    face = rng.integers(0, 255, (64, 64, 3), np.uint8)
    labels = np.zeros((64, 64), np.uint8)
    labels[8:44, 10:50] = 1
    labels[26:31, 28:34] = 10
    faceid = rng.standard_normal((1, 16)).astype(np.float32)
    init = rng.integers(0, 255, (64, 64, 3), np.uint8)
    mask = np.zeros((64, 64), np.uint8)
    mask[16:48, 20:44] = 255
    noise, posterior = (torch.from_numpy(
        rng.standard_normal((1, 32, 32, 4), np.float32)) for _ in range(2))
    channels = 9 if path == "inpaint9" else 4
    cls = {"img2img": ConsistentIDImg2ImgPipeline,
           "deepcache": ConsistentIDPipeline,
           "controlnet_inpaint": ConsistentIDControlNetInpaintPipeline}.get(
        path, ConsistentIDInpaintPipeline)
    cpu = tiny_bundle(device="cpu", seed=3, sample_channels=channels)
    gpu = tiny_bundle(device="cuda", sample_channels=channels)
    gpu.load_state_dict(cpu.state_dict())
    nets = {}
    if path == "controlnet_inpaint":
        nets["cpu"] = tiny_controlnet(cpu.unet_config, device="cpu")
        nets["cpu"].random_params(torch.Generator().manual_seed(4), 0.05)
        nets["cuda"] = tiny_controlnet(cpu.unet_config, device="cuda")
        nets["cuda"].load_state_dict(nets["cpu"].state_dict())
    outs = []
    with tf32_off():
        for bundle in (cpu, gpu):
            kw = {}
            if nets:
                kw = dict(controlnet=nets["cpu" if bundle is cpu else "cuda"],
                          control_guidance_end=0.6, guess_mode=True)
            pipe = cls(bundle, synthetic_clip_tokenizer(),
                       pipeline_config=PipelineConfig(height=64, width=64),
                       **kw)
            host = pipe.prepare_conditioning(
                "a photo of a man", face, parsing_labels=labels,
                faceid_embeds=faceid)
            host["init_image"] = sd_image_preprocess(init, 64, 64)
            host["pixel_mask"], host["latent_mask"] = preprocess_mask(
                mask, 64, 64, 32, 32)
            host["control_image"] = host["init_image"] * 0.5 + 0.5
            cond = pipe.device_cond(host)
            dev = bundle.device
            args = (cond, noise.to(dev), 5.0, 1, 4, "ddim", 1.0, 1.0)
            if path == "deepcache":
                img = pipe._generate_core(*args, cache_interval=2)
            elif path == "img2img":
                img = pipe._img2img_core(*args, 0.5,
                                         posterior_noise=posterior.to(dev))
            else:
                img = pipe._inpaint_core(*args, 0.75,
                                         posterior_noise=posterior.to(dev))
            outs.append(img.cpu())
    assert outs[1].shape == (1, 64, 64, 3)
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=1e-3)


def _tiny_sdxl_train_step(bundle, remat=None):
    """One SDXL train step of a tiny bundle (128 px, batch 2: level 1's
    self-attention, 1024 tokens, through the flash Function) on fixed
    draws: (loss, updated masters and the step's gradients, read back from
    AdamW's first moment, mu = (1 - b1) g from zero, on the CPU, K2 and
    K3 + K4 launches)."""
    from consistentid_torch.core import SchedulerConfig, TrainConfig
    from consistentid_torch.sampling import NoiseSchedule
    from consistentid_torch.training import (create_train_state, make_draws,
                                             make_train_step,
                                             sdxl_consistentid_loss,
                                             synthetic_batch)

    batch = synthetic_batch(2, 128, 28, 16, seed=4)
    batch["clean_ids2"] = batch["clean_ids"][:, ::-1].copy()
    batch["time_ids"] = torch.tensor([[128.0, 128, 0, 0, 128, 128]] * 2)
    draws = make_draws(torch.Generator().manual_seed(3), (2, 64, 64, 4),
                       1000)
    draws.__dict__.update({k: v.to(bundle.device)
                           for k, v in vars(draws).items()})
    if remat:
        bundle.remat, bundle.remat_policy = True, remat
    config = TrainConfig(localization_layers=3)
    state = create_train_state(bundle, config)
    wrappers = (port_flash.flash_attention_lse, port_flash.flash_attention_bwd)
    before = [w.launches for w in wrappers]
    step = make_train_step(bundle, NoiseSchedule.create(SchedulerConfig()),
                           config, loss_fn=sdxl_consistentid_loss)
    state, metrics = step(state, batch, draws)
    if bundle.device.type == "cuda":
        torch.cuda.synchronize()
    grads = {n: mu.cpu() / (1 - config.adam_b1)
             for n, mu in zip(state.trainable, state.optimizer.mu)}
    return (float(metrics["loss"]),
            {n: p.detach().cpu() for n, p in state.trainable.items()},
            grads, [w.launches - b for w, b in zip(wrappers, before)])


@pytest.mark.cuda
def test_tiny_sdxl_train_step_card_vs_cpu(cuda_generator):
    """The tiny fp32 SDXL bundle's train step on the card (K2 and K3 + K4 on
    their fp32 route, 3 launches each), TF32 off, against the CPU, with the
    CPU parity tests' limits: the loss relative 1e-5, each gradient leaf
    within 1e-4 of its largest element, each master within 2.5 lr (Adam's
    first step moves an element by lr times the sign of its gradient, so
    where fp32 noise flips a near-zero gradient the two differ by 2 lr)."""
    from consistentid_torch.testing import tiny_sdxl_bundle

    cpu = tiny_sdxl_bundle(device="cpu", seed=3)
    gpu = tiny_sdxl_bundle(device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    with tf32_off():
        cpu_loss, cpu_p, cpu_g, cpu_n = _tiny_sdxl_train_step(cpu)
        gpu_loss, gpu_p, gpu_g, gpu_n = _tiny_sdxl_train_step(gpu)
    assert cpu_n == [0, 0] and gpu_n == [3, 3]
    assert abs(gpu_loss - cpu_loss) <= 1e-5 * abs(cpu_loss)
    for name, w in cpu_g.items():
        scale = max(w.abs().max().item(), 1e-12)
        assert (gpu_g[name] - w).abs().max().item() <= 1e-4 * scale, name
        assert (gpu_p[name] - cpu_p[name]).abs().max().item() <= 2.5e-4


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_tiny_sdxl_remat_step_on_card(cuda_generator, policy):
    """The same step on the card with UNet remat against the step without
    it, both with deterministic algorithms (testing.deterministic: the
    capture's gather backward otherwise adds in any order): K2 runs again
    for the one non-captured level-1 block (3 -> 4 launches), K3 + K4 3;
    the loss relative 1e-5 and the masters within the JAX package's remat
    limits (rtol 2e-4, atol 2e-6)."""
    from consistentid_torch.testing import deterministic, tiny_sdxl_bundle

    with tf32_off(), deterministic():
        ref_loss, ref_p, _, ref_n = _tiny_sdxl_train_step(
            tiny_sdxl_bundle(device="cuda", seed=3))
        loss, got_p, _, n = _tiny_sdxl_train_step(
            tiny_sdxl_bundle(device="cuda", seed=3), remat=policy)
    assert ref_n == [3, 3] and n == [4, 3]
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    for name, w in ref_p.items():
        torch.testing.assert_close(got_p[name], w, rtol=2e-4, atol=2e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_function_gradients_match_plain(cuda_generator, dtype, monkeypatch):
    """Under autograd flash_attention returns the Function's output (the
    gradient no longer drops on the card); its gradients through K2 and
    K3 + K4 (the fused sm90 backward for 16-bit inputs, one launch) against
    the same Function with the plain versions swapped in."""
    shape, sk = (2, 3, 1000, 40), 1037
    q, k, v, do = _inputs(cuda_generator, shape, sk, dtype)
    grads = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(port_flash, "flash_attention_lse",
                                port_flash.flash_attention_lse_plain)
            monkeypatch.setattr(
                port_flash, "flash_attention_bwd",
                lambda *a: tuple(t.to(dtype) for t in
                                 port_flash.flash_attention_bwd_plain(*a)))
        else:
            routes = dict(port_flash.flash_attention_bwd.launches_by_route)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = port_flash.flash_attention(*leaves)
        assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
        out.backward(do)
        grads.append([t.grad.float() for t in leaves])
        if not plain:
            torch.cuda.synchronize()
            _assert_one_launch_on(port_flash.flash_attention_bwd, routes,
                                  _expected_route(dtype, shape[3]))
    torch.cuda.synchronize()
    for got, ref in zip(*grads):
        _assert_rel_l2(got, ref, dtype)


@pytest.mark.cuda
def test_backward_wrappers_reject_what_kernels_do_not_take(cuda_generator):
    g = cuda_generator
    q, k, v, do = _inputs(g, (1, 2, 64, 136), 64, torch.bfloat16)
    lse = torch.zeros((1, 2, 64), device="cuda")
    with pytest.raises(ValueError):          # head_dim > 128
        port_flash.flash_attention_lse(q, k, v)
    with pytest.raises(ValueError):
        port_flash.flash_attention_bwd(q, k, v, do, lse, lse)
    q, k, v, do = (t[..., :64].contiguous() for t in (q, k, v, do))
    with pytest.raises(TypeError):           # mixed dtypes
        port_flash.flash_attention_lse(q, k.float(), v)
    with pytest.raises(TypeError):
        port_flash.flash_attention_bwd(q, k, v.half(), do, lse, lse)
    with pytest.raises(TypeError):           # float64 on the card
        port_flash.flash_attention_lse(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):          # non-contiguous
        port_flash.flash_attention_lse(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError):
        port_flash.flash_attention_bwd(q, k, v, do.transpose(2, 3)
                                       .contiguous().transpose(2, 3),
                                       lse, lse)
    with pytest.raises(TypeError):           # lse must be fp32
        port_flash.flash_attention_bwd(q, k, v, do, lse.half(), lse)
    with pytest.raises(ValueError):          # delta (B, H, Sq)
        port_flash.flash_attention_bwd(q, k, v, do, lse, lse[..., :10])


# K5/K6 shapes: BiSeNet's stem (training at batch 16, 448 px crops; the
# parser at 512 px), ragged rows with C = 24 and 19, a C of more than 32
# vectors (several channel tiles)
BN_CASES = [
    ((16, 224, 224, 64), torch.float32),
    ((1, 256, 256, 64), torch.float32),
    ((1, 256, 256, 64), torch.bfloat16),
    ((1, 256, 256, 64), torch.float16),
    ((2, 9, 7, 24), torch.float32),
    ((2, 9, 7, 24), torch.bfloat16),
    ((1, 33, 17, 19), torch.float32),
    ((1, 33, 17, 19), torch.bfloat16),
    ((1, 33, 17, 19), torch.float16),
    ((2, 16, 16, 1000), torch.bfloat16),
]


def _bn_inputs(g, shape, dtype, misaligned=False):
    """randn plus per-channel offsets (mean and var of order 1); with
    `misaligned`, a contiguous tensor 4 bytes past a 16-byte boundary, which
    the wrappers run one channel per load."""
    c = shape[-1]
    x = torch.randn(shape, generator=g, device="cuda") + torch.randn(
        c, generator=g, device="cuda")
    if misaligned:
        buf = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
        x = buf[1:].view(shape).copy_(x)
    scale = torch.rand(c, generator=g, device="cuda") + 0.5
    bias = torch.randn(c, generator=g, device="cuda")
    return x.to(dtype), scale, bias


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", BN_CASES)
def test_bn_moments_kernel_matches_plain(cuda_generator, shape, dtype):
    x, _, _ = _bn_inputs(cuda_generator, shape, dtype)
    before = port_bn.batch_moments.launches
    mean, var = port_bn.batch_moments(x)
    torch.cuda.synchronize()
    assert port_bn.batch_moments.launches == before + 1
    assert mean.dtype == var.dtype == torch.float32
    ref_mean, ref_var = port_bn.batch_moments_plain(x)
    plan = port_bn.plan_for(x)
    ctl_mean, ctl_var = moments_without_last_cluster(x, plan)
    for got, ref, ctl in ((mean, ref_mean, ctl_mean), (var, ref_var, ctl_var)):
        assert torch.isfinite(got).all()
        assert rel_l2(got, ref) <= KERNEL_BN_MOMENTS_REL_L2
        assert rel_l2(ctl, ref) > KERNEL_BN_MOMENTS_REL_L2
    # and bit for bit the plain moments summed in the kernel's order
    want_mean, want_var = moments_in_kernel_order(x, plan)
    assert torch.equal(mean, want_mean) and torch.equal(var, want_var)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", BN_CASES)
@pytest.mark.parametrize("activation", port_bn.ACTIVATIONS)
def test_bn_apply_kernel_matches_plain(cuda_generator, shape, dtype,
                                       activation):
    x, scale, bias = _bn_inputs(cuda_generator, shape, dtype)
    mean, var = port_bn.batch_moments_plain(x)
    before = port_bn.apply_bn_act.launches
    y = port_bn.apply_bn_act(x, mean, var, scale, bias,
                             activation=activation)
    torch.cuda.synchronize()
    assert port_bn.apply_bn_act.launches == before + 1
    assert y.dtype == dtype and y.shape == x.shape
    ref = port_bn.apply_bn_act_plain(x, mean, var, scale, bias,
                                     activation=activation)
    limit = (KERNEL_BN_APPLY_REL_L2_FP32 if dtype == torch.float32
             else KERNEL_BN_APPLY_REL_L2_16BIT)
    assert rel_l2(y, ref) <= limit
    assert rel_l2(unnormalized_last_channels(x, ref), ref) > limit


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_kernels_one_channel_per_load(cuda_generator, dtype):
    """A tensor off a 16-byte boundary: both kernels read one channel per
    load (the scalar path) and agree with the plain versions."""
    x, scale, bias = _bn_inputs(cuda_generator, (2, 30, 30, 64), dtype,
                                misaligned=True)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    y, mean, var = port_bn.fused_bn_act(x, scale, bias, activation="silu")
    ref_mean, ref_var = port_bn.batch_moments_plain(x)
    assert rel_l2(mean, ref_mean) <= KERNEL_BN_MOMENTS_REL_L2
    assert rel_l2(var, ref_var) <= KERNEL_BN_MOMENTS_REL_L2
    ref = port_bn.apply_bn_act_plain(x, mean, var, scale, bias,
                                     activation="silu")
    limit = (KERNEL_BN_APPLY_REL_L2_FP32 if dtype == torch.float32
             else KERNEL_BN_APPLY_REL_L2_16BIT)
    assert rel_l2(y, ref) <= limit


def _device_kernels(fn, calls=3):
    """The device kernels torch.profiler records over `calls` calls of fn,
    by name, after one call outside it and a first profiler session that
    is thrown away (the first session of a process can miss the kernels of
    its first moments)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.cuda
@pytest.mark.parametrize("call,kernels", [
    ("batch_moments", ["bn_moments_kernel"]),
    ("apply_bn_act", ["bn_apply_kernel"]),
    ("fused_bn_act", ["bn_moments_kernel", "bn_apply_kernel"]),
])
def test_bn_calls_launch_one_kernel_each(cuda_generator, call, kernels):
    """One device kernel per K5 or K6 call, and two per fused_bn_act: no
    second pass over K5's partials, no separate kernels for rsqrt."""
    x, scale, bias = _bn_inputs(cuda_generator, (1, 256, 256, 64),
                                torch.float32)
    mean, var = port_bn.batch_moments_plain(x)
    fn = {"batch_moments": lambda: port_bn.batch_moments(x),
          "apply_bn_act": lambda: port_bn.apply_bn_act(x, mean, var, scale,
                                                       bias),
          "fused_bn_act": lambda: port_bn.fused_bn_act(x, scale, bias)}[call]
    names = _device_kernels(fn)   # over 3 calls
    assert len(names) == 3 * len(kernels), names
    for want in kernels:
        assert sum(want in name for name in names) == 3, names


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((1, 256, 256, 64), torch.float32),
    ((1, 256, 256, 64), torch.bfloat16),
    ((2, 16, 16, 1000), torch.bfloat16),
    ((1, 33, 17, 19), torch.float16),
])
def test_bn_moments_bits_repeat(cuda_generator, shape, dtype):
    """K5 three times on one x and once on a second stream: the same bits,
    and those of the plain moments summed in the kernel's order."""
    x, _, _ = _bn_inputs(cuda_generator, shape, dtype)
    runs = [port_bn.batch_moments(x) for _ in range(3)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        runs.append(port_bn.batch_moments(x))
    torch.cuda.synchronize()
    want = moments_in_kernel_order(x, port_bn.plan_for(x))
    for mean, var in runs:
        assert torch.equal(mean, want[0]) and torch.equal(var, want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ctas,cluster,row_lanes", [
    ((1, 48, 32, 16), 6, 2, 64),    # 6 CTAs: 3 clusters of 2
    ((1, 40, 34, 16), 5, 1, 64),    # 5 CTAs: clusters of 1
    ((1, 2, 2, 24), 1, 1, 32),      # 4 rows: fewer than a CTA's row lanes
    ((1, 1, 3, 19), 1, 1, 8),       # 3 rows, 1-wide loads
])
def test_bn_kernels_small_grids(cuda_generator, shape, ctas, cluster,
                                row_lanes):
    """Grids whose CTA count is not a multiple of 8 take a smaller cluster,
    and shapes of fewer rows than a CTA reads side by side: K5 and K6
    against their plain versions, K5 bit for bit in its order."""
    x, scale, bias = _bn_inputs(cuda_generator, shape, torch.float32)
    plan = port_bn.plan_for(x)
    assert (plan.ctas, plan.cluster, plan.row_lanes) == (ctas, cluster,
                                                         row_lanes)
    y, mean, var = port_bn.fused_bn_act(x, scale, bias)
    torch.cuda.synchronize()
    want_mean, want_var = moments_in_kernel_order(x, plan)
    assert torch.equal(mean, want_mean) and torch.equal(var, want_var)
    ref_mean, ref_var = port_bn.batch_moments_plain(x)
    assert rel_l2(mean, ref_mean) <= KERNEL_BN_MOMENTS_REL_L2
    assert rel_l2(var, ref_var) <= KERNEL_BN_MOMENTS_REL_L2
    ref = port_bn.apply_bn_act_plain(x, mean, var, scale, bias)
    assert rel_l2(y, ref) <= KERNEL_BN_APPLY_REL_L2_FP32


@pytest.mark.cuda
@pytest.mark.parametrize("stats", ["bfloat16", "float16", "strided"])
def test_bn_apply_kernel_other_statistics(cuda_generator, stats):
    """K6 on 16-bit and on non-contiguous statistics: the wrapper makes
    them fp32 and contiguous, the kernel computes rsqrt(var + eps), and
    the output matches the plain version on the same statistics."""
    x, scale, bias = _bn_inputs(cuda_generator, (2, 30, 30, 64),
                                torch.bfloat16)
    mean, var = port_bn.batch_moments_plain(x)
    if stats == "strided":
        mean, var, scale, bias = (torch.stack([t, t], 1)[:, 0]
                                  for t in (mean, var, scale, bias))
        assert not mean.is_contiguous()
    else:
        dt = getattr(torch, stats)
        mean, var, scale, bias = (t.to(dt) for t in (mean, var, scale, bias))
    y = port_bn.apply_bn_act(x, mean, var, scale, bias, eps=1e-3,
                             activation="silu")
    ref = port_bn.apply_bn_act_plain(x, mean, var, scale, bias, eps=1e-3,
                                     activation="silu")
    assert rel_l2(y, ref) <= KERNEL_BN_APPLY_REL_L2_16BIT
    assert rel_l2(unnormalized_last_channels(x, ref), ref) > (
        KERNEL_BN_APPLY_REL_L2_16BIT)


@pytest.mark.cuda
def test_bn_wrappers_reject_what_kernels_do_not_take(cuda_generator):
    x, scale, bias = _bn_inputs(cuda_generator, (2, 8, 8, 16), torch.float32)
    mean, var = port_bn.batch_moments(x)
    with pytest.raises(ValueError):          # non-contiguous
        port_bn.batch_moments(x.transpose(1, 2))
    with pytest.raises(ValueError):
        port_bn.apply_bn_act(x.transpose(1, 2), mean, var, scale, bias)
    with pytest.raises(ValueError):          # statistics on another device
        port_bn.apply_bn_act(x, mean.cpu(), var, scale, bias)
    with pytest.raises(ValueError):          # C mismatch of the statistics
        port_bn.apply_bn_act(x, mean[:8], var[:8], scale[:8], bias[:8])
    with pytest.raises(ValueError):          # unknown activation
        port_bn.apply_bn_act(x, mean, var, scale, bias, activation="gelu")
    with pytest.raises(TypeError):           # float64 on the card
        port_bn.batch_moments(x.double())
    with pytest.raises(ValueError):          # not NHWC
        port_bn.batch_moments(x[0])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["iresnet50", "bisenet"])
def test_perception_forward_card_vs_cpu(cuda_generator, name):
    """One forward at full width, fp32 with TF32 off, on the card and on the
    CPU from the same random weights and input (PERCEPTION_REL_L2)."""
    from consistentid_torch.models.arcface import IResNet
    from consistentid_torch.models.bisenet import BiSeNet

    model, size = ((IResNet(), 112) if name == "iresnet50"
                   else (BiSeNet(), 256))
    randomize_perception_module(model, torch.Generator().manual_seed(0))
    model.eval()
    x = torch.randn((2, size, size, 3), generator=torch.Generator()
                    .manual_seed(1))
    with tf32_off(), torch.no_grad():
        want = model(x)
        got = model.cuda()(x.cuda())
    for g, w in zip(got if name == "bisenet" else [got],
                    want if name == "bisenet" else [want]):
        assert rel_l2(g.cpu(), w) <= PERCEPTION_REL_L2


# ------------------------------------------------------------------ int8

# (M, K, N) of the int8 UNet's products at the headline request (SD1.5,
# batch 4 with CFG: 8 rows, 512 px): level-0 and level-1 3x3 convolutions,
# the stride-2 downsampling, a 1x1 shortcut, the 3x3 over 1280 channels,
# to_q and the GEGLU projection at level 0, to_k over the 81-token context;
# then m at and under cuBLASLt's limit of 17 (padded with zero rows)
INT_MM_SHAPES = [(32768, 2880, 320), (8192, 5760, 640), (8192, 2880, 320),
                 (8192, 320, 640), (512, 11520, 1280), (32768, 320, 320),
                 (32768, 320, 2560), (648, 768, 320), (17, 768, 320),
                 (16, 768, 320), (1, 64, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", INT_MM_SHAPES)
def test_int_mm_matches_plain_integer_product(cuda_generator, m, k, n):
    """torch._int_mm through `int_mm` against the exact integer product,
    bit for bit, random codes and all-extreme ones (+-127)."""
    from consistentid_torch.ops import quant

    g = cuda_generator
    for extreme in (False, True):
        a = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=g, device="cuda",
                          dtype=torch.int8)
        if extreme:
            a, w = torch.where(a >= 0, 127, -127).to(torch.int8), \
                torch.where(w >= 0, 127, -127).to(torch.int8)
        before = quant.int_mm.launches
        got = quant.int_mm(a, w.t())
        assert quant.int_mm.launches == before + 1
        want = quant.int_mm_plain(a, w.t())
        assert got.dtype == torch.int32 and got.shape == (m, n)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_int_mm_refuses_what_cublaslt_does_not_take(cuda_generator):
    """k or n not a multiple of 8: a ValueError naming the layer, never a
    float product."""
    from consistentid_torch.ops import quant

    a = torch.ones((32, 12), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="up_0_resnet_0.conv1"):
        quant.int_mm(a, torch.ones((12, 16), dtype=torch.int8,
                                   device="cuda"), "up_0_resnet_0.conv1")
    with pytest.raises(ValueError, match="n=12"):
        quant.int_mm(torch.ones((32, 16), dtype=torch.int8, device="cuda"),
                     torch.ones((16, 12), dtype=torch.int8, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("kind", ["conv3x3", "stride2", "conv1x1", "dense"])
def test_int8_layer_card_vs_cpu(cuda_generator, kind, static):
    """Int8Conv / Int8Dense on the card against the CPU, fp32: the codes,
    the integer products and the epilogue are the same arithmetic, so
    rtol 1e-6 (one layer on the same input)."""
    from consistentid_torch.models.layers import Int8Conv, Int8Dense
    from consistentid_torch.ops import quant

    gen = torch.Generator().manual_seed(3)
    if kind == "dense":
        layer = Int8Dense(320, 640, static=static)
        x = torch.randn((2, 77, 320), generator=gen)
        w = torch.randn((640, 320), generator=gen)
        kq, ks = quant.quantize_dense_kernel(w)
    else:
        k, stride, pad = {"conv3x3": (3, 1, 1), "stride2": (3, 2, 1),
                          "conv1x1": (1, 1, 0)}[kind]
        layer = Int8Conv(320, 640, k, stride, pad, static=static)
        x = torch.randn((2, 320, 17, 19), generator=gen)
        kq, ks = quant.quantize_conv_kernel(
            torch.randn((640, 320, k, k), generator=gen))
    state = {"kernel_q": kq, "kernel_scale": ks,
             "bias": 0.1 * torch.randn(640, generator=gen)}
    if static:
        state["act_scale"] = x.abs().amax() * 0.8 / 127
    layer.load_state_dict(state)
    want = layer(x)
    got = layer.cuda()(x.cuda())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("quant_mode", ["int8", "int8_static"])
def test_tiny_int8_unet_card_vs_cpu(cuda_generator, quant_mode,
                                    monkeypatch):
    """The tiny folded int8 UNet on the card against the CPU, fp32 with
    TF32 off, the CPU run's activation codes replayed on the card (a
    last-bit difference of a float layer flips codes at .5 boundaries,
    which the next layers spread; the CPU parity tests do the same against
    JAX): the card's own codes within one of the CPU's at fewer than 1 in
    1000 places, the outputs within 1e-5 relative L2."""
    from consistentid_torch.models import layers
    from consistentid_torch.ops import quant
    from consistentid_torch.testing import tiny_bundle

    bundle = tiny_bundle(device="cpu")
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((3, 16, 16, 4), generator=gen)
    t = torch.tensor([900.0, 500.0, 20.0])
    ctx = torch.randn((3, 81, 64), generator=gen)
    scales = None
    if quant_mode == "int8_static":
        unet = bundle.calibration_unet(0.8)
        with layers.calibration(unet) as records, torch.no_grad():
            unet(x, t, ctx)
        scales = quant.act_scales_to_numpy(
            quant.act_scales_from_calib(records, 1.1))
    codes, counts = [], {"calls": 0, "flips": 0, "total": 0, "max": 0}
    sym, fixed = layers.quantize_symmetric, layers.quantize_with_scale

    def record_sym(x, dims, keepdim=False):
        q, s = sym(x, dims, keepdim)
        codes.append(q)
        return q, s

    def record_fixed(x, s):
        codes.append(fixed(x, s))
        return codes[-1]

    def replay(q):
        want = codes.pop(0).to(q.device)
        diff = (want.int() - q.int()).abs()
        counts["calls"] += 1
        counts["flips"] += int((diff > 0).sum())
        counts["total"] += diff.numel()
        counts["max"] = max(counts["max"], int(diff.max()))
        return want

    with tf32_off(), torch.no_grad():
        with monkeypatch.context() as mp:
            mp.setattr(layers, "quantize_symmetric", record_sym)
            mp.setattr(layers, "quantize_with_scale", record_fixed)
            want = bundle.quantized(quant_mode, scales).infer_unet(0.8)(
                x, t, ctx)
        card = bundle.to("cuda")
        with monkeypatch.context() as mp:
            mp.setattr(layers, "quantize_symmetric",
                       lambda x, d, keepdim=False: (
                           lambda q, s: (replay(q), s))(*sym(x, d, keepdim)))
            mp.setattr(layers, "quantize_with_scale",
                       lambda x, s: replay(fixed(x, s)))
            before = quant.int_mm.launches
            got = card.quantized(quant_mode, scales).infer_unet(0.8)(
                x.cuda(), t.cuda(), ctx.cuda())
            launched = quant.int_mm.launches - before
    assert not codes and launched == counts["calls"] > 0
    assert counts["max"] <= 1 and counts["flips"] <= 1e-3 * counts["total"]
    assert rel_l2(got.cpu(), want) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bicubic", "lanczos", "bilinear"])
def test_pil_resize_card_vs_cpu(cuda_generator, kind):
    """The PIL resample on a card tensor (the safety checker's route) gives
    the CPU's bits (held to PIL's in tests/test_torch_quant.py,
    test_torch_train_data.py and test_torch_perception.py): down by more
    than 4, up, one axis, a grey image."""
    import numpy as np

    from consistentid_torch.utils import image as port_image
    rng = np.random.RandomState(0)
    for shape, (h, w) in (((512, 512, 3), (224, 224)),
                          ((72, 80, 3), (1024, 1024)),
                          ((300, 200, 3), (300, 77)),
                          ((37, 53), (512, 512))):
        img = rng.randint(0, 256, shape, np.uint8)
        want = port_image._resize_pil(img, h, w, kind)
        got = port_image._resize_pil(torch.from_numpy(img).cuda(), h, w,
                                     kind)
        assert got.device.type == "cuda" and got.dtype == torch.uint8
        np.testing.assert_array_equal(got.cpu().numpy(), want)


def _tiny_twins(dtype):
    """The tiny SD1.5 bundle on the CPU (fp32) and on the card in `dtype`,
    with the same weights."""
    from consistentid_torch.testing import tiny_bundle
    cpu = tiny_bundle(device="cpu", seed=3)
    card = tiny_bundle(device="cuda", dtype=dtype, seed=4)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


# the eval scorers and the PhotoMaker encoder on the card against the CPU:
# fp32 with TF32 off, summation order only (1e-5 on a cosine, relative L2
# 1e-5 on the fused embeds); bf16 towers, weights and activations rounded
# to 8 bits of mantissa (2e-2 on a cosine, relative L2 2e-2)
EVAL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_clip_t_scorer_card_vs_cpu(cuda_generator, dtype):
    import numpy as np

    from consistentid_torch.conditioning import SimpleTokenizer
    from consistentid_torch.eval import CLIPTScorer
    cpu, card = _tiny_twins(dtype)
    rng = np.random.RandomState(1)
    tp = rng.randn(64, 16).astype(np.float32)
    vp = rng.randn(32, 16).astype(np.float32)
    img = rng.randint(0, 255, (64, 48, 3), np.uint8)
    with tf32_off():
        for prompt in ("a man with a face", "a red hat " * 40):
            want = CLIPTScorer(cpu, SimpleTokenizer(), tp, vp)(prompt, img)
            got = CLIPTScorer(card, SimpleTokenizer(), tp, vp)(prompt, img)
            assert abs(got - want) <= EVAL_TOL[dtype], (prompt, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_photomaker_encoder_card_vs_cpu(cuda_generator, dtype):
    from consistentid_torch.core import CLIPVisionConfig
    from consistentid_torch.eval import PhotoMakerIDEncoder
    cfg = CLIPVisionConfig(image_size=28, patch_size=14, hidden_size=32,
                           intermediate_size=64, num_layers=2, num_heads=2)
    torch.manual_seed(0)
    cpu = PhotoMakerIDEncoder(cfg, projection_dim=8, projection_dim_2=8)
    card = PhotoMakerIDEncoder(cfg, projection_dim=8, projection_dim_2=8)
    card.load_state_dict(cpu.state_dict())
    card = card.to("cuda", dtype)
    g = torch.Generator().manual_seed(1)
    pixels = torch.randn(2, 3, 28, 28, 3, generator=g)
    prompt = torch.randn(2, 12, 16, generator=g)
    idx = torch.tensor([[2, 5, 9], [1, 3, 0]])
    mask = torch.tensor([[True, True, True], [True, True, False]])
    with torch.no_grad(), tf32_off():
        want = cpu(pixels, prompt, idx, mask)
        got = card(pixels.cuda().to(dtype), prompt.cuda().to(dtype),
                   idx.cuda(), mask.cuda())
    assert rel_l2(got.cpu(), want) <= EVAL_TOL[dtype]


@pytest.mark.cuda
def test_face_sim_scorer_card_vs_cpu(cuda_generator):
    """The tiny iresnet embedder (fp32, center crop) on both devices, TF32
    off: the FaceSim cosine within 1e-5."""
    import numpy as np

    from consistentid_torch.eval import FaceSimScorer
    from consistentid_torch.models.arcface import IResNet, make_face_embedder
    model = IResNet((1, 1, 1, 1), 16, 32)
    randomize_perception_module(model, torch.Generator().manual_seed(2))
    state = model.state_dict()
    rng = np.random.RandomState(3)
    ref = rng.randint(0, 255, (48, 40, 3), np.uint8)
    gen = np.clip(ref.astype(int) + rng.randint(-30, 30, ref.shape), 0,
                  255).astype(np.uint8)
    with tf32_off():
        want = FaceSimScorer(make_face_embedder(
            state, allow_center_crop=True, device="cpu"))(ref, gen)
        got = FaceSimScorer(make_face_embedder(
            state, allow_center_crop=True, device="cuda"))(ref, gen)
    assert abs(got - want) <= 1e-5


@pytest.mark.cuda
def test_validate_synthesize_tiny_on_card(cuda_generator, tmp_path):
    """`apps.validate --synthesize DIR --tiny --device cuda --sweep 2
    --mode-sweep 2`: every converter ok, the three pipelines, FaceSim,
    CLIP-T, the sweep and the seven serving modes of SD1.5 and SDXL, K1
    launched (the tiny UNets' 1024-token self-attention, fp32)."""
    import json

    from consistentid_torch.apps import validate
    out = str(tmp_path / "report.json")
    before = port_flash.flash_attention_fwd.launches
    assert validate.main(["--synthesize", str(tmp_path / "set"), "--tiny",
                          "--device", "cuda", "--sweep", "2",
                          "--mode-sweep", "2", "--out", out]) == 0
    with open(out) as f:
        report = json.load(f)
    assert report["ok"] and len(report["files"]) == 14
    assert set(report["pipelines"]) == {"sd15", "inpaint", "sdxl"}
    for key in ("mode_sweep", "mode_sweep_xl"):
        assert list(report["metrics"][key]) == [
            m for m, _, _ in validate.SERVING_MODES]
    assert {"face_sim", "clip_t"} <= set(report["metrics"])
    assert port_flash.flash_attention_fwd.launches > before


# ------------------------------------------------- LLaVA captioner, FGID

def _tiny_llava_pair():
    """The tiny LLaVA (fp32, seeded fan-in weights) on the CPU and a copy
    on the card, with the synthetic tokenizer."""
    import copy

    from consistentid_torch.conditioning.llama_tokenizer import \
        LlamaTokenizer
    from consistentid_torch.models.llava import random_llava
    from consistentid_torch.testing import (synthetic_llama_tokenizer_json,
                                            tiny_llava_config)
    cpu = random_llava(tiny_llava_config(), seed=0).eval()
    tok = LlamaTokenizer(synthetic_llama_tokenizer_json(512))
    return cpu, copy.deepcopy(cpu).cuda(), tok


def _tiny_faces(n=2):
    import numpy as np
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, (30 + 4 * i, 26 + 6 * i, 3),
                         dtype=np.uint8) for i in range(n)]


@pytest.mark.cuda
def test_tiny_llava_captions_card_vs_cpu(cuda_generator):
    """The tiny fp32 LLaVA's caption ids (batch 2, both FGID prompts, 12
    tokens) on the card equal the CPU's, TF32 off; no flash kernel runs
    (the tower's 5 tokens are far under the cutover)."""
    import numpy as np

    from consistentid_torch.conditioning.captioner import LlavaCaptioner
    cpu, card, tok = _tiny_llava_pair()
    before = port_flash.flash_attention_fwd.launches
    with tf32_off():
        for prompt in ("Describe the face.", "Who is this?"):
            want = LlavaCaptioner(cpu, tok, max_new_tokens=12).generate_ids(
                _tiny_faces(), prompt)
            got = LlavaCaptioner(card, tok, max_new_tokens=12).generate_ids(
                _tiny_faces(), prompt)
            np.testing.assert_array_equal(got, want)
    assert port_flash.flash_attention_fwd.launches == before


def _cached_logits(lm, ids, prefill, kv_quant):
    from consistentid_torch.models import llama
    with torch.no_grad():
        cache = llama.init_cache(lm.config, ids.shape[0], ids.shape[1],
                                 kv_quant=kv_quant, device=ids.device)
        out, cache = lm(ids[:, :prefill], cache=cache, cache_index=0,
                        attn_len=prefill)
        outs = [out]
        for i in range(prefill, ids.shape[1]):
            out, cache = lm(ids[:, i:i + 1], cache=cache, cache_index=i,
                            attn_len=ids.shape[1])
            outs.append(out)
    return torch.cat(outs, dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("quant,kv_quant", [(True, False), (True, True),
                                            (False, True)],
                         ids=["int8", "int8_kv", "kv"])
def test_int8_and_kv_quant_decode_card_vs_cpu(cuda_generator, quant,
                                              kv_quant):
    """Batch-1 prefill and decode of the tiny Llama on the card against
    the CPU, fp32 with TF32 off: under int8 each model call's 7 products
    a layer and lm_head go through torch._int_mm, m = 1 padded to 17; the
    logits within 1e-2 relative L2 (the card's fp32 sums may move an
    activation across a rounding boundary and flip its int8 code, one
    step of 1/127 of its token's range). Then greedy_generate on the card
    (its decode steps replayed from one CUDA graph) emits the argmax of
    the card's eager logits over its own stream, and counts the graph's
    _int_mm launches at each replay."""
    from consistentid_torch.models import llama
    from consistentid_torch.ops import quant as quant_ops
    cpu, _, _ = _tiny_llava_pair()
    cfg = cpu.config.text
    state = cpu.llama.state_dict()
    if quant:
        state = llama.quantize_llama_params(cfg, state)
    lm = llama.LlamaForCausalLM(cfg, quant=quant)
    lm.load_state_dict(state)
    ids = torch.randint(3, cfg.vocab_size, (1, 12),
                        generator=torch.Generator().manual_seed(4))
    per_call = 7 * cfg.num_layers + 1 if quant else 0
    with tf32_off():
        want = _cached_logits(lm, ids, 8, kv_quant)
        lm = lm.cuda()
        before = quant_ops.int_mm.launches
        got = _cached_logits(lm, ids.cuda(), 8, kv_quant)
        assert quant_ops.int_mm.launches - before == 5 * per_call
        assert rel_l2(got.cpu(), want) <= 1e-2
        before = quant_ops.int_mm.launches
        new = llama.greedy_generate(lm, ids[:, :8].cuda(), 6,
                                    eos_token_id=cfg.vocab_size + 1,
                                    kv_quant=kv_quant)
        assert quant_ops.int_mm.launches - before == 6 * per_call
        stream = torch.cat([ids[:, :8].cuda(), new], dim=1)
        eager = _cached_logits(lm, stream, 8, kv_quant)
    assert torch.equal(eager[:, 7:-1].argmax(-1), new)


@pytest.mark.cuda
def test_fgid_mask_and_faceid_card_vs_cpu(cuda_generator, tmp_path):
    """apps.fgid's mask stage (BiSeNet at 128 px) and faceid stage (a
    tiny iresnet) over 2 PNG faces on the card and on the CPU, TF32 off:
    the labels equal on at least PERCEPTION_LABEL_AGREEMENT of the pixels,
    the resized PNGs the same bytes, the embeddings within 1e-5."""
    import numpy as np

    from consistentid_torch.apps import fgid
    from consistentid_torch.io import export_backbones as exp
    from consistentid_torch.io.from_jax import tree_from_module
    from consistentid_torch.models.arcface import IResNet
    from consistentid_torch.models.bisenet import BiSeNet
    from consistentid_torch.testing import PERCEPTION_LABEL_AGREEMENT
    from consistentid_torch.utils.png import decode_png, encode_png

    images = tmp_path / "images"
    images.mkdir()
    for i, face in enumerate(_tiny_faces()):
        (images / f"face{i}.png").write_bytes(encode_png(face))
    gen = torch.Generator().manual_seed(0)
    parser, embedder = BiSeNet(), IResNet((1, 1, 1, 1), 32, 32)
    with torch.no_grad():
        randomize_perception_module(parser, gen)
        randomize_perception_module(embedder, gen)

    def save(sd, name):
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in sd.items()}, tmp_path / name)

    save(exp.bisenet_to_torch(*tree_from_module(parser)), "parser.pth")
    save(exp.iresnet_to_torch(*tree_from_module(
        embedder, flatten_nhwc={"fc": 512}), layers=(1, 1, 1, 1),
        spatial=2), "arcface.pt")
    with tf32_off():
        for device in ("cpu", "cuda"):
            out = str(tmp_path / device)
            fgid.run_mask(str(images), out, str(tmp_path / "parser.pth"),
                          batch_size=2, size=128, device=device)
            fgid.run_faceid(str(images), out, str(tmp_path / "arcface.pt"),
                            batch_size=2, device=device)
    agree = total = 0
    for i in range(2):
        read = {sub: [(tmp_path / d / sub / f"face{i}.{ext}").read_bytes()
                      for d in ("cpu", "cuda")]
                for sub, ext in (("resize", "png"), ("mask", "png"),
                                 ("faceid", "bin"))}
        assert read["resize"][0] == read["resize"][1]
        labels = [decode_png(b) for b in read["mask"]]
        agree += int((labels[0] == labels[1]).sum())
        total += labels[0].size
        want, got = (np.frombuffer(b, np.float32) for b in read["faceid"])
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-5
    assert agree >= PERCEPTION_LABEL_AGREEMENT * total


# ------------------------------------------------------------------ demo

@pytest.mark.cuda
def test_demo_callback_on_card(cuda_generator):
    """The gradio demo's request callback (apps.demo.demo_callback) on the
    tiny fp32 bundle on the card, its face parsed and embedded by stub
    hooks, 3 DDIM steps across the merge step at 1, 64 px (the level-0
    self-attention crosses the flash cutover: 9 K1 launches on the fp32
    route): a (64, 64, 3) uint8 image, `generate`'s first image bit for
    bit; and with the initial latents injected, TF32 off, the decoded
    image within the CPU parity tests' 1e-3 on [-1, 1] of the same request
    on the CPU."""
    import numpy as np

    from consistentid_torch.apps.demo import demo_callback
    from consistentid_torch.core import PipelineConfig
    from consistentid_torch.pipelines import ConsistentIDPipeline
    from consistentid_torch.testing import (synthetic_clip_tokenizer,
                                            tiny_bundle)

    rng = np.random.default_rng(0)
    face = rng.integers(0, 255, (64, 64, 3), np.uint8)
    labels = np.zeros((64, 64), np.uint8)
    labels[8:44, 10:50] = 1
    labels[26:31, 28:34] = 10
    faceid = rng.standard_normal((1, 16)).astype(np.float32)
    latents = torch.from_numpy(rng.standard_normal((1, 32, 32, 4),
                                                   np.float32))
    request = (face, "a photo of a man", "blurry", 3.0, 1.0, 5.0, 2024.0)
    cpu = tiny_bundle(device="cpu", seed=3)
    gpu = tiny_bundle(device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    wrapper = port_flash.flash_attention_fwd
    floats = []
    with tf32_off():
        for bundle in (cpu, gpu):
            pipe = ConsistentIDPipeline(
                bundle, synthetic_clip_tokenizer(),
                pipeline_config=PipelineConfig(height=64, width=64),
                face_parser=lambda image: labels,
                face_embedder=lambda image: faceid)
            run = demo_callback(pipe)
            if bundle is gpu:
                routes = dict(wrapper.launches_by_route)
                img = run(*request)
                torch.cuda.synchronize()
                moved = {r: n - routes[r]
                         for r, n in wrapper.launches_by_route.items()}
                assert moved == {r: 9 * (r == "f32") for r in moved}
                assert img.shape == (64, 64, 3) and img.dtype == np.uint8
                np.testing.assert_array_equal(img, pipe.generate(
                    "a photo of a man", face, negative_prompt="blurry",
                    num_inference_steps=3, start_merge_step=1,
                    guidance_scale=5.0, seed=2024)[0])
            real = pipe._run

            def injected(cond, drawn, *rest, real=real, **kw):
                out = real(cond, latents.to(drawn.device), *rest, **kw)
                floats.append(out.float().cpu())
                return out

            pipe._run = injected
            run(*request)
    torch.testing.assert_close(floats[1], floats[0], rtol=0, atol=1e-3)
