"""K2, K3 and K4 in the PyTorch port on the CPU: the plain versions against
the JAX Pallas kernels (interpret mode), the autograd Function against
autograd through plain attention, gradcheck in float64, and the dispatch
under autograd. The kernels themselves are held against the plain versions
on the card in test_torch_cuda.py."""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from consistentid_torch.ops import attention as port_attention
from consistentid_torch.ops import build
from consistentid_torch.ops import flash_attention as port_flash

# the package's ops/__init__ re-exports the function under the module's name
jax_flash = importlib.import_module("consistentid_tpu.ops.flash_attention")

RAGGED = [((1, 2, 200, 40), 300), ((1, 2, 130, 80), 77)]


def _arrays(seed, shape, sk):
    b, h, sq, d = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, np.float32)
            for s in (shape, (b, h, sk, d), (b, h, sk, d), shape)]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# fp32 on both sides; the JAX kernels stream keys in blocks with an online
# softmax, the plain versions take one softmax per row block: summation
# order only, 1e-5 absolute on O(1) values.
@pytest.mark.parametrize("shape,sk", RAGGED)
def test_lse_plain_matches_jax_kernel(shape, sk):
    q, k, v, _ = _arrays(1, shape, sk)
    scale = 1.0 / np.sqrt(shape[-1])
    want_o, want_lse = jax_flash._flash_forward_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
        block_q=128, block_k=128, interpret=True)
    got_o, got_lse = port_flash.flash_attention_lse_plain(*_t(q, k, v), scale)
    assert got_o.shape == shape and got_lse.shape == shape[:3]
    assert got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape,sk", RAGGED)
def test_bwd_plain_matches_jax_kernels(shape, sk):
    """K3's and K4's function on the same q, k, v, dO, lse, delta (lse and
    delta from the JAX forward, so only the backward is compared)."""
    q, k, v, do = _arrays(2, shape, sk)
    scale = 1.0 / np.sqrt(shape[-1])
    out, lse = jax_flash._flash_forward_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
        block_q=128, block_k=128, interpret=True)
    delta = jnp.sum(jnp.asarray(do) * out, axis=-1)
    want = jax_flash._flash_backward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(do), lse,
        delta, scale, block_q=128, block_k=128, interpret=True)
    got = port_flash.flash_attention_bwd_plain(
        *_t(q, k, v, do, np.asarray(lse), np.asarray(delta)), scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_bwd_plain_rounds_like_the_tensor_core_kernels(dtype):
    """round_to rounds P and dS to the 16-bit type before their products
    (fp32 accumulation), as K3 and K4 do on the card; that is the control
    the card checks hold them to. Spelled out here on one (Sq, Sk) block:
    fp32 sums in another order only, 1e-6."""
    q, k, v, do = _t(*_arrays(7, (1, 2, 40, 24), 56))
    lse = torch.logsumexp(q @ k.transpose(-1, -2) * 0.2, dim=-1)
    delta = torch.from_numpy(
        np.random.default_rng(8).standard_normal((1, 2, 40), np.float32))
    p = torch.exp(q @ k.transpose(-1, -2) * 0.2 - lse[..., None])
    ds = p * (do @ v.transpose(-1, -2) - delta[..., None])
    p16, ds16 = p.to(dtype).float(), ds.to(dtype).float()
    want = (ds16 @ k * 0.2, ds16.transpose(-1, -2) @ q * 0.2,
            p16.transpose(-1, -2) @ do)
    got = port_flash.flash_attention_bwd_plain(q, k, v, do, lse, delta, 0.2,
                                               round_to=dtype)
    exact = port_flash.flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                                 0.2)
    for name, g, w, e in zip(("dq", "dk", "dv"), got, want, exact):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6, msg=name)
        assert not torch.equal(g, e), name


@pytest.mark.parametrize("shape,sk", RAGGED)
def test_function_grads_match_autograd_of_plain_attention(shape, sk):
    """The Function (plain K2, K3, K4 on CPU tensors) against autograd
    through reference_attention: fp32, summation order only, 1e-5."""
    q, k, v, do = _t(*_arrays(3, shape, sk))
    grads = []
    for fn in (port_flash.flash_attention, port_attention.reference_attention):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves)
        out.backward(do)
        grads.append((out.detach(), *(t.grad for t in leaves)))
    for name, g, w in zip(("o", "dq", "dk", "dv"), *grads):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5, msg=name)


def test_function_gradcheck_float64():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_(True)
               for s in ((1, 2, 5, 3), (1, 2, 7, 3), (1, 2, 7, 3)))
    assert torch.autograd.gradcheck(
        lambda a, b, c: port_flash.FlashAttentionFunction.apply(a, b, c, 0.7),
        (q, k, v), eps=1e-6, atol=1e-8)


def test_grad_fn_is_the_function_on_cpu():
    """Under autograd the entry point returns the Function's output (the
    fault where the card's output carried no grad_fn is closed; the card's
    side is in test_torch_cuda.py); without it, K1's path, which launches
    nothing on CPU tensors."""
    q, k, v, _ = _t(*_arrays(5, (1, 2, 64, 16), 64))
    launches = [port_flash.flash_attention_fwd.launches,
                port_flash.flash_attention_lse.launches,
                port_flash.flash_attention_bwd_dq.launches,
                port_flash.flash_attention_bwd_dkv.launches]
    out = port_flash.flash_attention(q.requires_grad_(True), k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    with torch.no_grad():
        assert port_flash.flash_attention(q, k, v).grad_fn is None
    assert port_flash.flash_attention(q.detach(), k, v).grad_fn is None
    assert launches == [port_flash.flash_attention_fwd.launches,
                        port_flash.flash_attention_lse.launches,
                        port_flash.flash_attention_bwd_dq.launches,
                        port_flash.flash_attention_bwd_dkv.launches]


def test_dispatch_under_grad_reaches_the_function():
    """At the cutover the dispatch sends attention that needs a gradient to
    the Function; return_probs still forces plain torch."""
    q = torch.zeros(1, 1, 1024, 8, requires_grad=True)
    kv = torch.zeros(1, 1, 1024, 8)
    out = port_attention.dot_product_attention(q, kv, kv)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    out, probs = port_attention.dot_product_attention(q, kv, kv,
                                                      return_probs=True)
    assert "FlashAttention" not in type(out.grad_fn).__name__
    assert probs.shape == (1, 1, 1024, 1024)


def test_backward_wrappers_check_their_inputs():
    q, k, v, do = _t(*_arrays(6, (1, 2, 20, 16), 30))
    lse = torch.zeros(1, 2, 20)
    with pytest.raises(ValueError):
        port_flash.flash_attention_bwd_dq(q, k, v, do[:, :, :10], lse, lse)
    with pytest.raises(ValueError):
        port_flash.flash_attention_bwd_dkv(q, k, v, do, lse[..., :5], lse)
    with pytest.raises(TypeError):
        port_flash.flash_attention_bwd_dq(q, k, v, do, lse.half(), lse)
    dq = port_flash.flash_attention_bwd_dq(q, k, v, do, lse, lse)
    dk, dv = port_flash.flash_attention_bwd_dkv(q, k, v, do, lse, lse)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape


def test_backward_source_and_libraries():
    text = (build.CSRC_DIR / "flash_attention_bwd.cu").read_text()
    for symbol in ("cid_flash_attention_backward_dq",
                   "cid_flash_attention_backward_dkv"):
        assert symbol in text
        assert port_flash._SIGNATURES[symbol][0] == "flash_attention_bwd"
    assert "cid_flash_attention_forward_lse" in (
        build.CSRC_DIR / "flash_attention.cu").read_text()
    assert set(build.LIBRARIES) == {"flash_attention", "flash_attention_bwd"}
    assert "atomic" not in text.split("#include")[1]   # deterministic sums
