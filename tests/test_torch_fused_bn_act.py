"""K5 and K6's plain versions on the CPU against the JAX package's Pallas
kernels in interpret mode (`batch_moments`, `apply_bn_act`, `fused_bn_act`),
the moments summed in K5's order (`moments_in_kernel_order`) against JAX's,
the kernels' launch plan (`bn_plan`),
the SyncBN variant over 2 gloo processes against JAX's `fused_bn_act` of the
concatenated batch, and the wrappers' CPU dispatch. Inputs are drawn with
numpy from a seed; channel offsets keep mean and var of order 1.

Tolerances: mean and var 2e-6 absolute (fp32 sums of a few hundred values
of order 1, in another order than the Pallas kernel's); fp32 outputs 1e-5
(that difference carried through the normalization, against values of
order 1); 16-bit outputs one bf16 ulp (2^-7 relative, 1e-5 absolute near
zero), where the same fp32 value on both sides lands on either side of a
rounding boundary.
"""
import dataclasses
import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from consistentid_tpu.ops import fused_bn_act as jax_bn
from consistentid_torch.ops import fused_bn_act as port_bn
from consistentid_torch.testing import moments_in_kernel_order

REPO = Path(__file__).resolve().parents[1]
ACTIVATIONS = ("leaky_relu", "relu", "silu", "identity")
RAGGED = (3, 13, 17, 19)     # 663 rows, not a multiple of 512; C = 19


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (rng.randn(*shape) + rng.randn(c)).astype(np.float32)
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    return x, scale, bias


def _pair(x, bf16):
    """The same values as a JAX and a torch array (bf16 rounds the same way
    on both sides: to nearest even)."""
    if bf16:
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    return jnp.asarray(x), torch.from_numpy(x)


def _assert_out(got: torch.Tensor, want, bf16: bool):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    if bf16:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_moments(shape, bf16):
    """JAX's batch_moments in interpret mode on `_inputs(shape, 0)`, once
    for the tests that compare with it."""
    x, _, _ = _inputs(shape, 0)
    jx, _ = _pair(x, bf16)
    return tuple(np.asarray(a) for a in jax_bn.batch_moments(
        jx, interpret=True))


@pytest.mark.parametrize("shape", [(2, 9, 7, 24), RAGGED])
@pytest.mark.parametrize("bf16", [False, True])
def test_batch_moments_matches_jax(shape, bf16):
    x, _, _ = _inputs(shape, 0)
    _, tx = _pair(x, bf16)
    want_mean, want_var = _jax_moments(shape, bf16)
    mean, var = port_bn.batch_moments(tx)
    assert mean.dtype == var.dtype == torch.float32
    assert mean.shape == var.shape == (shape[-1],)
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(want_var), rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize("shape", [(2, 9, 7, 24), RAGGED])
@pytest.mark.parametrize("bf16", [False, True])
def test_moments_in_kernel_order_matches_jax(shape, bf16):
    """The moments summed in K5's order (what the card holds the kernel to
    bit for bit) against JAX's kernel: in the wrapper's plan, and in one
    of 16-row spans in 12 clusters of 4 (the last CTAs empty), so that
    spans, ranks and partial rows all meet."""
    x, _, _ = _inputs(shape, 0)
    _, tx = _pair(x, bf16)
    want_mean, want_var = _jax_moments(shape, bf16)
    plan = port_bn.plan_for(tx)
    small = dataclasses.replace(plan, rows_per_cta=16, ctas=48, cluster=4,
                                partial_rows=12, final_lanes=4)
    for plan in (plan, small):
        mean, var = moments_in_kernel_order(tx, plan)
        assert mean.dtype == var.dtype == torch.float32
        np.testing.assert_allclose(mean.numpy(), want_mean, rtol=0,
                                   atol=2e-6)
        np.testing.assert_allclose(var.numpy(), want_var, rtol=0, atol=2e-6)


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("bf16", [False, True])
def test_apply_bn_act_matches_jax(activation, bf16):
    """The same moments on both sides (JAX's own), so only K6 is compared."""
    x, scale, bias = _inputs((2, 9, 7, 24), 1)
    jx, tx = _pair(x, bf16)
    mean, var = (np.array(a) for a in jax_bn.batch_moments(
        jx, interpret=True))
    want = jax_bn.apply_bn_act(jx, jnp.asarray(mean), jnp.asarray(var),
                               jnp.asarray(scale), jnp.asarray(bias),
                               activation=activation, interpret=True)
    got = port_bn.apply_bn_act(tx, *(torch.from_numpy(a) for a in
                                     (mean, var, scale, bias)),
                               activation=activation)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _assert_out(got, want, bf16)


@pytest.mark.parametrize("bf16", [False, True])
def test_fused_bn_act_matches_jax_ragged(bf16):
    x, scale, bias = _inputs(RAGGED, 2)
    jx, tx = _pair(x, bf16)
    want_y, want_mean, want_var = jax_bn.fused_bn_act(
        jx, jnp.asarray(scale), jnp.asarray(bias), slope=0.2, interpret=True)
    y, mean, var = port_bn.fused_bn_act(tx, torch.from_numpy(scale),
                                        torch.from_numpy(bias), slope=0.2)
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(want_var), rtol=0,
                               atol=2e-6)
    _assert_out(y, want_y, bf16)


def test_unknown_activation_raises():
    x = torch.zeros((1, 2, 2, 4))
    c = torch.ones(4)
    with pytest.raises(ValueError, match="gelu"):
        port_bn.apply_bn_act(x, c, c, c, c, activation="gelu")
    with pytest.raises(ValueError, match="gelu"):
        port_bn.apply_bn_act_plain(x, c, c, c, c, activation="gelu")
    with pytest.raises(ValueError, match="gelu"):
        jax_bn.apply_bn_act(jnp.zeros((1, 2, 2, 4)), *([jnp.ones(4)] * 4),
                            activation="gelu", interpret=True)


def test_cpu_tensors_take_the_plain_path():
    """A CPU tensor runs the plain versions (the same values, bit for bit)
    and launches nothing; the wrappers check what they are given."""
    x, scale, bias = _inputs((2, 5, 3, 8), 3)
    tx, ts, tb = (torch.from_numpy(a) for a in (x, scale, bias))
    before = (port_bn.batch_moments.launches, port_bn.apply_bn_act.launches)
    y, mean, var = port_bn.fused_bn_act(tx, ts, tb, activation="silu")
    assert (port_bn.batch_moments.launches,
            port_bn.apply_bn_act.launches) == before == (0, 0)
    pm, pv = port_bn.batch_moments_plain(tx)
    assert torch.equal(mean, pm) and torch.equal(var, pv)
    assert torch.equal(y, port_bn.apply_bn_act_plain(tx, pm, pv, ts, tb,
                                                     activation="silu"))
    with pytest.raises(ValueError):          # stats of another width
        port_bn.apply_bn_act(tx, mean[:4], var, ts, tb)
    with pytest.raises(ValueError):          # not NHWC
        port_bn.batch_moments(tx[0])
    with pytest.raises(TypeError):
        port_bn.batch_moments(tx.double())


# (shape, dtype, aligned) -> the plan's vec, cvp, c_tiles; K5's
# rows_per_cta, ctas, cluster, partial_rows, final_lanes; K6's apply_blocks
PLANS = [
    ((16, 224, 224, 64), torch.float32, True,      # BiSeNet training's stem
     (4, 16, 1, 3041, 264, 8, 33, 4, 1046)),
    ((1, 256, 256, 64), torch.float32, True,       # the parser's stem, P
     (4, 16, 1, 256, 256, 8, 32, 2, 1024)),
    ((1, 256, 256, 64), torch.bfloat16, True,
     (8, 8, 1, 256, 256, 8, 32, 2, 256)),
    ((2, 9, 7, 24), torch.float32, True,           # fewer rows than a CTA
     (4, 8, 1, 126, 1, 1, 1, 1, 1)),
    ((1, 33, 17, 19), torch.bfloat16, True,        # C = 19, 1-wide loads
     (1, 32, 1, 281, 2, 2, 1, 1, 9)),
    ((2, 16, 16, 1000), torch.bfloat16, True,      # four channel tiles
     (8, 32, 4, 256, 2, 2, 1, 1, 8)),
    ((2, 30, 30, 64), torch.float32, False,        # an unaligned pointer
     (1, 32, 2, 258, 7, 1, 7, 1, 57)),
]


@pytest.mark.parametrize("shape,dtype,aligned,want", PLANS)
def test_kernel_layout(shape, dtype, aligned, want):
    """The launch the kernels run with (`bn_plan`; the card tests hold the
    kernels at each kind): 16-byte vectors where C and the pointer allow,
    power-of-two lanes over a row's vectors, tiles past 32 vectors; K5 a
    persistent grid of about 2 CTAs an SM in whole clusters of up to 8
    (a smaller one where the count is not a multiple of 8), every row
    covered; K6 at most 8 CTAs an SM, the fewest that take the row groups
    in as many rounds, so that no CTA takes more than one group above
    another."""
    c = shape[-1]
    rows = int(np.prod(shape[:-1]))
    plan = port_bn.bn_plan(rows, c, dtype, aligned)
    assert (plan.vec, plan.cvp, plan.c_tiles, plan.rows_per_cta, plan.ctas,
            plan.cluster, plan.partial_rows, plan.final_lanes,
            plan.apply_blocks) == want
    assert port_bn.channel_layout(c, dtype, aligned) == want[:3]
    assert plan.apply_rows_in_flight == (4 if dtype == torch.float32 else 8)
    assert plan.ctas % plan.cluster == 0 and plan.cluster in (1, 2, 4, 8)
    assert (plan.ctas - 1) * plan.rows_per_cta < rows <= (
        plan.ctas * plan.rows_per_cta)
    assert plan.ctas * plan.c_tiles <= 2 * port_bn.H100_SMS
    # the last cluster loads the partial rows in one round, in one warp
    assert plan.final_lanes * 16 >= plan.partial_rows
    assert plan.final_lanes <= 32
    assert plan.apply_blocks * plan.c_tiles <= 8 * port_bn.H100_SMS
    groups = -(-rows // (plan.row_lanes * plan.apply_rows_in_flight))
    rounds = -(-groups // plan.apply_blocks)   # of the grid-stride loop
    assert (plan.apply_blocks - 1) * rounds < groups <= (
        plan.apply_blocks * rounds)


_RANK = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from consistentid_torch.ops.fused_bn_act import sync_batch_norm_act
rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=2, rank=rank)
data = np.load(path)
x = torch.from_numpy(data["x"][rank * 2:(rank + 1) * 2])
y, mean, var = sync_batch_norm_act(x, torch.from_numpy(data["scale"]),
                                   torch.from_numpy(data["bias"]))
np.savez(f"{path[:-4]}_{rank}.npz", y=y.numpy(), mean=mean.numpy(),
         var=var.numpy())
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_sync_batch_norm_act_two_gloo_ranks(tmp_path):
    """Two processes, two images each, all-reduce over gloo: the global
    moments and each rank's slice of JAX's fused_bn_act over all four."""
    x, scale, bias = _inputs((4, 5, 6, 8), 4)
    path = str(tmp_path / "inputs.npz")
    np.savez(path, x=x, scale=scale, bias=bias)
    port = str(_free_port())
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), port,
                               path], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    want_y, want_mean, want_var = jax_bn.fused_bn_act(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
        interpret=True)
    for r in range(2):
        got = np.load(f"{path[:-4]}_{r}.npz")
        np.testing.assert_allclose(got["mean"], np.asarray(want_mean),
                                   rtol=0, atol=2e-6)
        np.testing.assert_allclose(got["var"], np.asarray(want_var), rtol=0,
                                   atol=2e-6)
        np.testing.assert_allclose(got["y"],
                                   np.asarray(want_y)[r * 2:(r + 1) * 2],
                                   rtol=0, atol=1e-5)
