"""K1 on the card: the CUDA kernel against its plain PyTorch version, for
each dtype and head-dim instantiation, ragged sequence tails included. Needs
an NVIDIA GPU and nvcc; skips elsewhere. Imports no JAX, so it runs on a
machine without it:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import pytest
import torch

from consistentid_torch.ops import flash_attention as port_flash


@pytest.fixture
def cuda_generator():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the flash kernel is CUDA only)")
    return torch.Generator("cuda").manual_seed(0)


# bf16/fp16: P is rounded to the input type before P V, as in any
# tensor-core flash kernel, and the output to one ulp: 1e-2 on |o| < 1.
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
])
def test_kernel_matches_plain(cuda_generator, shape, sk, dtype, atol):
    g = cuda_generator
    b, h, sq, d = shape
    q = torch.randn(shape, generator=g, device="cuda").to(dtype)
    k = torch.randn((b, h, sk, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, h, sk, d), generator=g, device="cuda").to(dtype)
    before = port_flash.flash_attention.launches
    out = port_flash.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert port_flash.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == shape
    ref = port_flash.flash_attention_plain(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=atol)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_generator):
    q = torch.randn((1, 1, 8, 136), generator=cuda_generator, device="cuda")
    with pytest.raises(ValueError):
        port_flash.flash_attention(q, q, q)
    q = q[..., :64].double()
    with pytest.raises(TypeError):
        port_flash.flash_attention(q, q, q)
