"""K1 in the PyTorch port: the plain version against the JAX Pallas kernel
(interpret mode) on the CPU, the dispatch cutover, the CPU route, the CUDA
source and its build command. The kernel itself is held against its plain
version on the card in test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from consistentid_tpu.ops.flash_attention import flash_attention as jax_flash
from consistentid_torch.ops import attention as port_attention
from consistentid_torch.ops import build
from consistentid_torch.ops import flash_attention as port_flash


def _qkv(seed, b, h, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d), np.float32),
            rng.standard_normal((b, h, sk, d), np.float32),
            rng.standard_normal((b, h, sk, d), np.float32))


# fp32: both sides accumulate in fp32 but in different orders (blockwise
# online softmax vs one softmax per row), so 1e-5 absolute on O(0.1-1)
# outputs. bf16 in: inputs rounded identically on both sides, fp32 math,
# output rounded to bf16 (8 bits): one bf16 ulp at |o| < 2 is 2**-7.
@pytest.mark.parametrize("d", [40, 64, 80])
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2 ** -7)])
def test_plain_matches_jax_kernel(d, dtype, atol):
    q, k, v = _qkv(d, 1, 2, 200, 300, d)
    want = np.asarray(jax_flash(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        block_q=128, interpret=True).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = port_flash.flash_attention_plain(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt))
    assert got.dtype == tdt and got.shape == (1, 2, 200, d)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("sq,sk,flash", [(1024, 1024, True),
                                         (4096, 256, True),
                                         (1023, 1024, False),
                                         (4096, 77, False)])
def test_dispatch_threshold(monkeypatch, sq, sk, flash):
    """Same cutover as the JAX dispatch: Sq * Sk >= 1024 * 1024 goes to the
    flash kernel; return_probs and use_flash=False never do."""
    calls = []

    def spy(q, k, v, sm_scale=None):
        calls.append(q.shape)
        return port_flash.flash_attention_plain(q, k, v, sm_scale)

    monkeypatch.setattr(port_flash, "flash_attention", spy)
    q = torch.zeros(1, 1, sq, 8)
    kv = torch.zeros(1, 1, sk, 8)
    port_attention.dot_product_attention(q, kv, kv)
    assert bool(calls) == flash
    calls.clear()
    port_attention.dot_product_attention(q, kv, kv, use_flash=False)
    port_attention.dot_product_attention(q, kv, kv, return_probs=True)
    assert not calls
    assert port_attention.FLASH_MIN_ELEMS == 1024 * 1024


def test_cpu_tensors_take_plain_path():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 70, 90, 40))
    before = port_flash.flash_attention_fwd.launches
    out = port_flash.flash_attention(q, k, v)
    assert port_flash.flash_attention_fwd.launches == before
    ref = port_attention.reference_attention(q, k, v)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        port_flash.flash_attention(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError):
        port_flash.flash_attention(q, k[:, :, :10], v)
    with pytest.raises(TypeError):
        port_flash.flash_attention(q.double(), k.double(), v.double())
    big = torch.zeros(1, 1, 4, 136)
    with pytest.raises(ValueError):
        port_flash.flash_attention(big, big, big)


def test_cuda_source_and_build_command():
    src = build.CSRC_DIR / "flash_attention.cu"
    text = src.read_text()
    assert "cid_flash_attention_forward" in text
    assert '#include "flash_common.cuh"' in text
    assert "mma.sync.aligned.m16n8k16" in (
        build.CSRC_DIR / "flash_common.cuh").read_text()
    cmd = build.nvcc_command("nvcc", [src], build.BUILD_DIR / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert build.BUILD_DIR.parts[-2:] == ("build", "kernels")



def _route_inputs(shape, dtype, sk=None, offset=0):
    """q, k, v of `shape` (k, v with sk keys); offset > 0: q a contiguous
    view that many elements into its storage."""
    b, h, sq, d = shape
    buf = torch.zeros(offset + b * h * sq * d, dtype=dtype)
    q = buf[offset:].view(shape)
    kv = torch.zeros((b, h, sk or sq, d), dtype=dtype)
    return q, kv, kv.clone()


@pytest.mark.parametrize("shape,dtype,offset,scale,route", [
    ((8, 8, 4096, 40), torch.bfloat16, 0, None, "sm90"),   # serving L0
    ((8, 8, 1024, 80), torch.bfloat16, 0, None, "sm90"),   # serving L1
    ((2, 8, 4096, 40), torch.float16, 0, None, "sm90"),
    ((1, 2, 77, 64), torch.bfloat16, 0, None, "sm90"),
    ((1, 2, 77, 128), torch.float16, 0, None, "sm90"),
    ((1, 2, 77, 36), torch.bfloat16, 0, None, "mma"),      # d % 8 != 0
    ((1, 2, 77, 100), torch.float16, 0, None, "mma"),
    ((1, 2, 77, 40), torch.bfloat16, 1, None, "mma"),      # q off 16 bytes
    ((1, 2, 77, 40), torch.bfloat16, 8, None, "sm90"),     # 16 bytes in
    ((1, 2, 77, 40), torch.bfloat16, 0, -0.5, "mma"),      # negative scale
    ((8, 8, 4096, 40), torch.float32, 0, None, "f32"),
    ((1, 2, 77, 36), torch.float32, 0, None, "f32"),
])
def test_forward_route(shape, dtype, offset, scale, route):
    """The kernel K1 and K2 launch for a CUDA call, decided from dtype, head
    dim, alignment and scale alone (the CPU tensors here stand for them)."""
    q, k, v = _route_inputs(shape, dtype, offset=offset)
    assert q.is_contiguous()
    assert port_flash.forward_route(q, k, v, scale) == route


@pytest.mark.parametrize("d,depth", [(8, 48), (40, 48), (48, 48), (56, 64),
                                     (64, 64), (80, 80), (96, 128),
                                     (128, 128)])
def test_sm90_padded_depth(d, depth):
    assert port_flash.sm90_padded_depth(d) == depth


def test_sm90_padded_depth_refuses_other_head_dims():
    for d in (36, 100, 136, 0):
        with pytest.raises(ValueError):
            port_flash.sm90_padded_depth(d)


def test_sm90_library_build_and_symbols():
    """The sm90 kernel is its own library (its nvcc runs beside the others),
    built for sm_90a with the ptxas report on, a wgmma kernel fed by TMA,
    with the C signatures of the mma kernel's entry points."""
    assert build.LIBRARIES["flash_attention_sm90"] == (
        "flash_attention_sm90.cu",)
    src = build.CSRC_DIR / "flash_attention_sm90.cu"
    cmd = build.nvcc_command("nvcc", [src], build.BUILD_DIR / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("-Xptxas") + 1] == "-v"
    # the source and the Hopper helpers it shares with the backward
    text = src.read_text() + (build.CSRC_DIR / "sm90_common.cuh").read_text()
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor",
                   "mbarrier.try_wait", "ex2.approx.ftz.f32",
                   'extern "C" int cid_flash_attention_forward_sm90',
                   'extern "C" int cid_flash_attention_forward_lse_sm90'):
        assert needle in text, needle
    sig = port_flash._SIGNATURES
    for new, old in (("cid_flash_attention_forward_sm90",
                      "cid_flash_attention_forward"),
                     ("cid_flash_attention_forward_lse_sm90",
                      "cid_flash_attention_forward_lse")):
        assert sig[new][0] == "flash_attention_sm90"
        assert sig[new][1] == sig[old][1]
    assert port_flash._ROUTE_SYMBOLS["sm90"] == (
        "cid_flash_attention_forward_sm90",
        "cid_flash_attention_forward_lse_sm90")


def test_ptxas_report_parse():
    text = (
        "ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3fooPf\n"
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 112 registers, used 1 barriers, 1024 bytes "
        "smem, 400 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'\n"
        "ptxas info    : Used 32 registers, 360 bytes cmem[0]\n")
    assert build.ptxas_report(text) == [
        dict(function="_Z3fooPf", registers=112, shared_bytes=1024,
             stack_bytes=8, spill_stores=4, spill_loads=4),
        dict(function="_Z3barv", registers=32, shared_bytes=0,
             stack_bytes=0, spill_stores=0, spill_loads=0)]


def test_reset_launches_splits_by_route():
    fwd = port_flash.flash_attention_fwd
    saved = (fwd.launches, dict(fwd.launches_by_route))
    try:
        fwd.launches, fwd.launches_by_route["mma"] = 3, 3
        port_flash.reset_launches(fwd)
        assert fwd.launches == 0
        assert fwd.launches_by_route == {"sm90": 0, "mma": 0, "f32": 0}
    finally:
        fwd.launches, fwd.launches_by_route = saved[0], saved[1]
