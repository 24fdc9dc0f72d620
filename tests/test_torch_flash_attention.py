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
    before = port_flash.flash_attention.launches
    out = port_flash.flash_attention(q, k, v)
    assert port_flash.flash_attention.launches == before
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
    assert "mma.sync.aligned.m16n8k16" in text
    cmd = build.nvcc_command("nvcc", [src], build.BUILD_DIR / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert build.BUILD_DIR.parts[-2:] == ("build", "kernels")

