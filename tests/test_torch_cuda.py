"""K1-K4 on the card: each CUDA kernel against its plain PyTorch version,
for each dtype and head-dim instantiation, ragged sequence tails included;
the autograd Function's gradients through the kernels against those through
the plain versions; what the wrappers refuse. Needs an NVIDIA GPU and nvcc;
skips elsewhere. Imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import pytest
import torch

from consistentid_torch.ops import flash_attention as port_flash
from consistentid_torch.testing import (KERNEL_REL_L2_16BIT,
                                        KERNEL_REL_L2_FP32,
                                        KERNEL_REL_L2_SAME_PRECISION,
                                        drop_last_tile, rel_l2)


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
])
def test_kernel_matches_plain(cuda_generator, shape, sk, dtype, atol):
    g = cuda_generator
    b, h, sq, d = shape
    q = torch.randn(shape, generator=g, device="cuda").to(dtype)
    k = torch.randn((b, h, sk, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, h, sk, d), generator=g, device="cuda").to(dtype)
    before = port_flash.flash_attention_fwd.launches
    out = port_flash.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert port_flash.flash_attention_fwd.launches == before + 1
    assert out.dtype == dtype and out.shape == shape
    ref = port_flash.flash_attention_plain(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=atol)
    cut = drop_last_tile(sk)
    _assert_rel_l2(out, ref, dtype, port_flash.flash_attention_plain(
        q, k[:, :, :cut], v[:, :, :cut]))


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
    ((1, 4, 4096, 40), 4096, torch.bfloat16),
    ((2, 3, 1000, 40), 1037, torch.bfloat16),
    ((1, 2, 130, 100), 170, torch.bfloat16),
    ((2, 2, 300, 64), 300, torch.float16),
    ((1, 2, 77, 36), 99, torch.float16),
    ((2, 3, 1000, 40), 1037, torch.float32),
    ((2, 3, 333, 64), 517, torch.float32),
    ((1, 2, 130, 128), 70, torch.float32),
]


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
@pytest.mark.parametrize("shape,sk,dtype", BWD_CASES)
def test_lse_kernel_matches_plain(cuda_generator, shape, sk, dtype):
    q, k, v, _ = _inputs(cuda_generator, shape, sk, dtype)
    before = port_flash.flash_attention_lse.launches
    out, lse = port_flash.flash_attention_lse(q, k, v)
    torch.cuda.synchronize()
    assert port_flash.flash_attention_lse.launches == before + 1
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
    q, k, v, do = _inputs(cuda_generator, shape, sk, dtype)
    out, lse = port_flash.flash_attention_lse_plain(q, k, v)
    delta = (do.float() * out.float()).sum(-1)
    n_dq = port_flash.flash_attention_bwd_dq.launches
    n_dkv = port_flash.flash_attention_bwd_dkv.launches
    dq = port_flash.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = port_flash.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert port_flash.flash_attention_bwd_dq.launches == n_dq + 1
    assert port_flash.flash_attention_bwd_dkv.launches == n_dkv + 1
    refs = port_flash.flash_attention_bwd_plain(q, k, v, do, lse, delta)
    same = [None] * 3 if dtype == torch.float32 else \
        port_flash.flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                             round_to=dtype)
    # controls: the last key tile dropped for dq, the last query tile for
    # dk and dv
    kc, qc = drop_last_tile(sk), drop_last_tile(shape[2])
    controls = [port_flash.flash_attention_bwd_plain(
        q, k[:, :, :kc], v[:, :, :kc], do, lse, delta)[0],
        *port_flash.flash_attention_bwd_plain(
            q[:, :, :qc], k, v, do[:, :, :qc], lse[:, :, :qc],
            delta[:, :, :qc])[1:]]
    for name, got, ref, ctl, sm in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                       refs, controls, same):
        assert got.dtype == dtype and got.shape == ref.shape, name
        _assert_rel_l2(got, ref, dtype, ctl, sm)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_function_gradients_match_plain(cuda_generator, dtype, monkeypatch):
    """Under autograd flash_attention returns the Function's output (the
    gradient no longer drops on the card); its gradients through K2-K4
    against the same Function with the plain versions swapped in."""
    shape, sk = (2, 3, 1000, 40), 1037
    q, k, v, do = _inputs(cuda_generator, shape, sk, dtype)
    grads = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(port_flash, "flash_attention_lse",
                                port_flash.flash_attention_lse_plain)
            monkeypatch.setattr(
                port_flash, "flash_attention_bwd_dq",
                lambda *a: port_flash.flash_attention_bwd_plain(*a)[0]
                .to(dtype))
            monkeypatch.setattr(
                port_flash, "flash_attention_bwd_dkv",
                lambda *a: tuple(t.to(dtype) for t in
                                 port_flash.flash_attention_bwd_plain(*a)[1:]))
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = port_flash.flash_attention(*leaves)
        assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
        out.backward(do)
        grads.append([t.grad.float() for t in leaves])
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
        port_flash.flash_attention_bwd_dq(q, k, v, do, lse, lse)
    q, k, v, do = (t[..., :64].contiguous() for t in (q, k, v, do))
    with pytest.raises(TypeError):           # mixed dtypes
        port_flash.flash_attention_lse(q, k.float(), v)
    with pytest.raises(TypeError):
        port_flash.flash_attention_bwd_dkv(q, k, v.half(), do, lse, lse)
    with pytest.raises(TypeError):           # float64 on the card
        port_flash.flash_attention_lse(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):          # non-contiguous
        port_flash.flash_attention_lse(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError):
        port_flash.flash_attention_bwd_dq(q, k, v, do.transpose(2, 3)
                                          .contiguous().transpose(2, 3),
                                          lse, lse)
    with pytest.raises(TypeError):           # lse must be fp32
        port_flash.flash_attention_bwd_dkv(q, k, v, do, lse.half(), lse)
