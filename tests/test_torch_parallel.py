"""The port's parallel/ package on torch.distributed against the JAX
package's parallel/, on the CPU at tiny widths, fp32.

The 2-rank cases run in one launch of the port's own launcher (2 gloo
processes on a free port, a module fixture, as
tests/test_multiprocess_dcn.py spawns once): the ranks import
tests/torch_parallel_workers.py, never JAX, and return their results here.

  - the split plans, leaf by leaf against JAX's unet_param_shardings and
    llama_param_shardings (float and int8 trees);
  - the TP=2 UNet forward with LoRA (folded before the split) and IP
    tokens against JAX's replicated forward (one jit): 1e-4 absolute at an
    output scale of about 1, the tolerance of the single-device UNet
    parity (tests/test_torch_modules.py);
  - the TP=2 tiny Llama in fp32 (logits to 1e-5; greedy tokens equal) and
    int8 (the codes and the int32 products are the single-rank ones:
    logits to 1e-5, tokens equal), the captioner over a mesh;
  - DP=2 generate / generate_batch against single-rank: uint8 within 1 on
    under 5% of the pixels (JAX's own bound, test_tensor_parallel.py);
    two buckets served in lockstep;
  - the DP=2 train step against the single-rank grad-accumulation step
    over the same shards and draws: loss 1e-5, masters rtol 2e-4 /
    atol 2e-6 (the single-rank step against JAX's is
    tests/test_torch_training.py's);
  - MicroBatcher mesh buckets against JAX's; initialize_multihost without
    an environment and with a failing coordinator; the heads check.
"""
import dataclasses
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from consistentid_tpu.apps import serve as jax_serve
from consistentid_tpu.core import config as jax_config
from consistentid_tpu.models import unet as jax_unet
from consistentid_tpu.models.llama import (LlamaForCausalLM as JaxLlama,
                                           quantize_llama_params as jax_q)
from consistentid_tpu.parallel import make_mesh as jax_make_mesh
from consistentid_tpu.parallel import tensor_parallel as jax_tp
from consistentid_torch.apps import serve as port_serve
from consistentid_torch.core import config as port_config
from consistentid_torch.io import params_from_jax
from consistentid_torch.parallel import (Mesh, apply_tensor_parallel,
                                         initialize_multihost, launch,
                                         llama_split_plan, make_mesh,
                                         unet_split_plan, world_size)
from consistentid_torch.pipelines.consistentid_sd15 import \
    check_tensor_parallel
from test_torch_modules import TINY_UNET, init_params, port_cfg

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_workers as workers  # noqa: E402

LORA_SCALE, IP_SCALE = 0.7, 0.8


@pytest.fixture(scope="module")
def tiny_unet(tmp_path_factory):
    """The tiny UNet's JAX module, parameters and inputs; and the launch of
    every 2-rank case, started here so the ranks run while the JAX tests
    before `ranks` do."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 16, 4), np.float32)
    t = np.array([801.0, 41.0], np.float32)
    ctx = rng.standard_normal((2, 9 + 4, 64), np.float32)
    mod = jax_unet.UNet(TINY_UNET)
    params = init_params(mod, 4, x, jnp.asarray(t), ctx)
    path = str(tmp_path_factory.mktemp("parallel") / "inputs.pt")
    torch.save({"unet_state": params_from_jax(params),
                "unet_config": dataclasses.asdict(
                    port_cfg(port_config.UNetConfig, TINY_UNET)),
                "lora_scale": LORA_SCALE, "ip_scale": IP_SCALE,
                "x": x, "t": t, "ctx": ctx}, path)
    pool = ThreadPoolExecutor(1)
    future = pool.submit(launch, workers.parallel_cases, 2, path,
                         device_type="cpu")
    yield mod, params, x, t, ctx, future
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def ranks(tiny_unet):
    """JAX's replicated forward of the tiny UNet (one jit, compiled while
    the ranks run) and both ranks' results of every 2-rank case."""
    mod, params, x, t, ctx, future = tiny_unet
    want = np.asarray(jax.jit(lambda p, *a: mod.apply(
        {"params": p}, *a, ip_scale=IP_SCALE, lora_scale=LORA_SCALE))(
            params, x, jnp.asarray(t), ctx))
    return want, future.result()


def _spec(sharding) -> str:
    spec = tuple(sharding.spec)
    return {(None, "model"): "col", ("model", None): "row",
            ("model",): "col"}.get(spec, None) if any(spec) else None


def _port_state(tree) -> dict:
    """Empty tensors under the port's state keys, in the port's layouts,
    for a flax tree of arrays or shapes (params_from_jax's key map)."""
    state = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        shape = tuple(leaf.shape)
        if keys[-1] in ("kernel", "kernel_q"):
            shape = shape[::-1] if len(shape) == 2 else shape
        leaf_name = {"kernel": "weight", "scale": "weight",
                     "embedding": "weight"}.get(keys[-1], keys[-1])
        state[".".join(keys[:-1] + [leaf_name])] = torch.empty(shape)
    return state


def _jax_plan(shardings) -> dict:
    """{port state key: "col" | "row"} of a JAX sharding tree, through
    params_from_jax's key map (kernel -> weight, scale -> weight)."""
    flat = {}
    for path, s in jax.tree_util.tree_flatten_with_path(shardings)[0]:
        keys = [p.key for p in path]
        leaf = {"kernel": "weight", "scale": "weight"}.get(keys[-1],
                                                           keys[-1])
        flat[".".join(keys[:-1] + [leaf])] = _spec(s)
    return {k: v for k, v in flat.items() if v}


def test_unet_split_plan_matches_jax(tiny_unet):
    params = tiny_unet[1]
    mesh = jax_make_mesh(jax.devices()[:2], model=2)
    want = _jax_plan(jax_tp.unet_param_shardings(params, mesh))
    got = unet_split_plan(params_from_jax(params))
    assert got == want
    assert sum(v == "col" for v in got.values()) > 0
    assert sum(v == "row" for v in got.values()) > 0


def test_llama_split_plan_matches_jax():
    """Float and int8 Llama trees: the kernels, and the int8 scales of the
    column-split layers (JAX's kernel_scale follows the column shard)."""
    from consistentid_torch.testing import TINY_LLAVA_TEXT
    cfg = jax_config.LlamaConfig(**TINY_LLAVA_TEXT)
    ids = jnp.zeros((1, 4), jnp.int32)
    params = jax.eval_shape(JaxLlama(cfg).init, jax.random.PRNGKey(0),
                            ids)["params"]
    mesh = jax_make_mesh(jax.devices()[:2], model=2)
    for tree in (params, jax.eval_shape(lambda p: jax_q(cfg, p), params)):
        want = _jax_plan(jax_tp.llama_param_shardings(tree, mesh))
        got = llama_split_plan(_port_state(tree))
        assert got == want
        assert "lm_head.weight" in got or "lm_head.kernel_q" in got


def test_int8_unet_is_not_split_by_jax_rule(tiny_unet):
    """JAX's UNet rule matches leaves named `kernel`; the int8 UNet's are
    `kernel_q`, so under a model axis it shards none of the quantized
    projections (a fault of the reference, ROADMAP §C), and the port's plan
    leaves them whole too."""
    from consistentid_tpu.models.unet import UNet as JUNet
    _, params, x, t, ctx, _ = tiny_unet
    cfg = dataclasses.replace(TINY_UNET, lora_rank=0)
    qtree = jax.eval_shape(
        lambda: JUNet(cfg, quant=True).init(
            jax.random.PRNGKey(0), x, jnp.asarray(t), ctx))["params"]
    mesh = jax_make_mesh(jax.devices()[:2], model=2)
    want = _jax_plan(jax_tp.unet_param_shardings(qtree, mesh))
    assert not [k for k in want if "kernel_q" in k or k.endswith(
        ("to_q.weight", "ff.proj.weight", "ff.out.weight"))]
    assert want and all("_ip" in k for k in want)
    assert not [k for k in unet_split_plan(_port_state(qtree))
                if "kernel_q" in k]


def test_tp_unet_matches_jax_replicated(ranks):
    """Traps 1-4: the GEGLU halves, local heads (IP branch included), the
    row-parallel bias added once, LoRA folded before the split."""
    want, ranks = ranks
    for r in ranks:
        tp = r["tp_unet"]
        assert tp["heads"] * 2 == tp["whole_heads"] == 2
        assert tp["to_q"] == (16, 32) and tp["to_k_ip"] == (16, 64)
        np.testing.assert_allclose(tp["out"], want, rtol=0, atol=1e-4)


def test_tp_llama_matches_single_rank(ranks):
    ranks = ranks[1]
    for r in ranks:
        out = r["tp_llama"]
        for name in ("fp32", "int8"):
            np.testing.assert_allclose(out[f"{name}_tp_logits"],
                                       out[f"{name}_one_logits"], rtol=0,
                                       atol=1e-5)
            np.testing.assert_array_equal(out[f"{name}_tp_tokens"],
                                          out[f"{name}_one_tokens"])
            assert out[f"{name}_kv_heads"] == 1
        assert out["caption_tp"] == out["caption_one"]


def _within_one_on_few(got, want):
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.05, (
        diff.max(), (diff > 0).mean())


def test_dp_generate_reproduces_single_rank(ranks):
    ranks = ranks[1]
    for r in ranks:
        out = r["dp_generate"]
        for key in ("gen_ddim", "gen_ddpm", "batch"):
            assert out[f"{key}_dp"].shape == out[f"{key}_one"].shape
            _within_one_on_few(out[f"{key}_dp"], out[f"{key}_one"])
    assert ranks[0]["dp_generate"]["buckets"] == [2, 4]
    _within_one_on_few(ranks[0]["dp_generate"]["lockstep"],
                       ranks[0]["dp_generate"]["batch_one"][:2])
    assert ranks[1]["dp_generate"]["followed"] == 1
    assert [r["mesh"][:4] for r in ranks] == [(2, 1, 0, "gloo"),
                                               (2, 1, 1, "gloo")]


def test_dp_train_step_equals_single_rank_accumulation(ranks):
    ranks = ranks[1]
    for r in ranks:
        out = r["dp_train"]
        for i in range(2):
            np.testing.assert_allclose(out[f"loss_dp_{i}"],
                                       out[f"loss_one_{i}"], rtol=1e-5)
        assert out["masters_dp"].keys() == out["masters_one"].keys()
        for k, v in out["masters_one"].items():
            np.testing.assert_allclose(out["masters_dp"][k], v, rtol=2e-4,
                                       atol=2e-6, err_msg=k)
    for k, v in ranks[0]["dp_train"]["masters_dp"].items():
        np.testing.assert_array_equal(ranks[1]["dp_train"]["masters_dp"][k],
                                      v, err_msg=k)


@pytest.mark.parametrize("data,model,max_batch", [
    (1, 1, 4), (4, 1, 6), (2, 2, 3), (2, 1, 1), (3, 1, 8)])
def test_microbatcher_mesh_buckets_match_jax(data, model, max_batch):
    class FakeMesh:
        shape = {"data": data, "model": model}

    class FakePipe:
        mesh = FakeMesh() if data * model > 1 else None

    want = jax_serve.MicroBatcher(FakePipe(), max_batch=max_batch,
                                  window_ms=1.0)
    got = port_serve.MicroBatcher(FakePipe(), max_batch=max_batch,
                                  window_ms=1.0)
    try:
        assert got.buckets == want.buckets
        assert got.max_batch == want.max_batch
        assert [got._bucket_size(n) for n in range(1, 9)] == \
            [want._bucket_size(n) for n in range(1, 9)]
    finally:
        want.stop()
        got.stop()


@pytest.mark.parametrize("dp,tp,visible,want", [
    (1, 1, 8, 1), (1, 2, 1, 1), (2, 1, 1, 1), (0, 1, 8, 8), (0, 2, 7, 6),
    (2, 2, 8, 4), (4, 1, 2, 2)])
def test_serve_mesh_ranks_follow_jax_rules(dp, tp, visible, want):
    assert port_serve.mesh_ranks(dp, tp, visible) == want


def test_initialize_multihost_without_environment_and_failing():
    assert world_size() == 1
    with pytest.warns(UserWarning, match="world size 1"):
        initialize_multihost(device_type="cpu")
    assert world_size() == 1
    mesh = make_mesh(device_type="cpu")
    assert (mesh.data, mesh.model, mesh.data_group) == (1, 1, None)
    with pytest.raises(ValueError, match="host:port"):
        initialize_multihost("nowhere", 2, 1, device_type="cpu")
    with pytest.raises(RuntimeError):
        initialize_multihost("localhost:1", 2, 1, device_type="cpu",
                             timeout_s=0.5)
    assert world_size() == 1


def test_tp_degree_must_divide_heads(tiny_unet):
    from consistentid_torch.models import UNet
    check_tensor_parallel(port_cfg(port_config.UNetConfig, TINY_UNET), 2)
    cfg = port_config.UNetConfig(**{
        **port_cfg(port_config.UNetConfig, TINY_UNET).__dict__,
        "num_attention_heads": (2, 3, 2, 2), "lora_rank": 0})
    with pytest.raises(ValueError, match="3 attention heads"):
        check_tensor_parallel(cfg, 2)
    fake = Mesh(data=1, model=2, rank=0, device=torch.device("cpu"),
                backend="gloo")
    with pytest.raises(ValueError, match="3 attention heads"):
        apply_tensor_parallel(UNet(cfg), fake)
    lora = UNet(port_cfg(port_config.UNetConfig, TINY_UNET))
    with pytest.raises(ValueError, match="fold LoRA"):
        apply_tensor_parallel(lora, fake)
    # SDXL's level-1 10 heads split over 2 and 5, not 4
    xl = port_config.sdxl_unet_config()
    check_tensor_parallel(xl, 2)
    check_tensor_parallel(xl, 5)
    with pytest.raises(ValueError, match="10 attention heads"):
        check_tensor_parallel(xl, 4)


def test_launcher_gives_each_rank_its_environment(ranks):
    ranks = ranks[1]
    assert [(r["env"]["rank"], r["env"]["world"], r["env"]["local"])
            for r in ranks] == [(0, 2, "0"), (1, 2, "1")]
