"""The port's BiSeNet trainer and tools against the JAX package's
training/bisenet_train.py and apps/bisenet_tools.py, on the CPU.

The JAX train state is drawn in numpy (the shapes of `BiSeNet.init` by
eval_shape: an eager flax init takes tens of seconds here), stepped once by
JAX, and carried across whole (`bisenet_train_state_from_jax`: parameters,
batch statistics, the four groups' momentum traces and counts), so the
port starts at step 1 with momentum (the 2-rank step starts from the drawn
state, carried at step 0). The schedule is cut to a 2-step
warm-up and 10 iterations so the steps cross from warm-up to poly decay.

Batch 8 (4 a rank in the 2-rank step; the reference trains at 16 a
device): at batch 2 the BatchNorms over 1 x 1 maps (the attention and
global-context branches) see two values a channel and the fp32 gradients
of either side scatter by whole per cents. Tolerances: the loss 1e-5
relative; parameters the training checks' master tolerance (rtol 2e-4,
atol 2e-6); batch statistics 2e-4 relative / 1e-5 absolute; the momentum
traces (the gradients, summed) 6% of each leaf's largest entry. That is
the fp32 noise of these gradients on an Intel Xeon CPU, not a slack in
the math: against the same step in fp64, JAX's 2-device step is off by
up to 5.4% of a leaf's largest entry (resnet.layer2_1.conv2) and the
port's by up to 0.8%, depending on the convolution library (oneDNN or
PyTorch's own kernels) and the thread count. The distributed math
itself is held exactly: the 2-rank step is also run in fp64 and held to
the same step in fp64 in one process at 1e-6 of each leaf's largest
entry. The 2-rank SyncBN step
(2 gloo processes, the port's launcher; the only place where the math
differs from one device) is held to JAX's step on a 2-device mesh with the
tolerances above.
"""
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from consistentid_tpu.apps import bisenet_tools as jax_tools
from consistentid_tpu.models.bisenet import BiSeNet as JaxBiSeNet
from consistentid_tpu.parallel import make_mesh as jax_make_mesh
from consistentid_tpu.training import bisenet_train as jax_bt
from consistentid_torch.apps import bisenet_tools as port_tools
from consistentid_torch.io.from_jax import bisenet_train_state_from_jax
from consistentid_torch.parallel import launch
from consistentid_torch.training import bisenet_train as port_bt
from consistentid_torch.utils.png import encode_png, read_array

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_workers as workers  # noqa: E402

SCHED = dict(lr0=1e-3, warmup_steps=2, max_iter=10)
CROP = 64


def _draw_state():
    """Numpy params and batch statistics in BiSeNet's init shapes."""
    shapes = jax.eval_shape(JaxBiSeNet(train=True).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, CROP, CROP, 3)))
    rng = np.random.default_rng(7)

    def draw(path, x):
        name = jax.tree_util.keystr(path[-1:])
        shape = np.shape(x)
        if "kernel" in name:
            fan_in = int(np.prod(shape[:-1]))
            return rng.standard_normal(shape, np.float32) / np.sqrt(fan_in)
        if "scale" in name or "var" in name:
            return 1.0 + 0.1 * np.abs(rng.standard_normal(shape, np.float32))
        return 0.1 * rng.standard_normal(shape, np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return tree["params"], tree["batch_stats"]


def _batch(n, seed):
    rng = np.random.RandomState(seed)
    images = rng.randn(n, CROP, CROP, 3).astype(np.float32)
    labels = rng.randint(0, 19, (n, CROP, CROP)).astype(np.int32)
    labels[:, :8] = port_bt.IGNORE_LABEL
    return images, labels


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX's state after one step (the carried start) and its next two
    single-device steps; JAX's 2-device step from the drawn state, and the
    2-rank port step from the same state carried across (one launch, run
    while JAX compiles)."""
    params, stats = _draw_state()
    opt = jax_bt.make_bisenet_optimizer(**SCHED)
    state0 = jax_bt.BiSeNetTrainState(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, stats),
        jax.jit(opt.init)(params), jnp.zeros((), jnp.int32))
    images, labels = _batch(8, 9)
    path = str(tmp_path_factory.mktemp("bisenet") / "inputs.pt")
    torch.save({"state": bisenet_train_state_from_jax(
        jax.device_get(state0)), "images": images, "labels": labels}, path)
    step = jax_bt.make_bisenet_train_step(opt)
    mesh_step = jax_bt.make_bisenet_train_step(
        opt, mesh=jax_make_mesh(jax.devices()[:2]))
    batches = [_batch(8, s) for s in range(3)]
    # the ranks, JAX's 2-device step and its single-device chain at once
    # (XLA compiles the two graphs on other threads)
    with ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(launch, workers.bisenet_sync_step, 2, path,
                            device_type="cpu")
        meshed = pool.submit(mesh_step, state0, images, labels)
        state, _ = step(state0, *batches[0])
        start = jax.device_get(state)
        singles = []
        for b in batches[1:]:
            state, m = step(state, *b)
            singles.append((jax.device_get(state), float(m["loss"])))
        mstate, mm = meshed.result()
        mesh = (jax.device_get(mstate), float(mm["loss"]))
        ranks = ranks.result()
    return dict(start=start, carried=bisenet_train_state_from_jax(start),
                batches=batches, singles=singles, mesh=mesh, ranks=ranks)


def _assert_state(model_state, momentum, want, loss=None, want_loss=None,
                  grad_tol=6e-2):
    carried = bisenet_train_state_from_jax(want)
    for k, v in carried["model"].items():
        if k.endswith("num_batches_tracked"):
            continue
        got = np.asarray(model_state[k])
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got, v.numpy(), rtol=2e-4, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got, v.numpy(), rtol=2e-4, atol=2e-6,
                                       err_msg=k)
    assert momentum.keys() == carried["momentum"].keys()
    for k, v in carried["momentum"].items():
        err = np.abs(np.asarray(momentum[k]) - v.numpy()).max()
        assert err <= grad_tol * np.abs(v.numpy()).max() + 1e-7, (k, err)
    if loss is not None:
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)


def test_carried_state_is_whole(world):
    c = world["carried"]
    assert c["step"] == 1 and set(c["count"].values()) == {1}
    state = port_bt.create_bisenet_train_state(device="cpu", state=c, **SCHED)
    assert state.model.state_dict().keys() == {
        k for k in c["model"]} and state.step == 1
    assert c["momentum"].keys() == dict(state.model.named_parameters()).keys()
    assert any(float(v.abs().max()) > 0 for v in c["momentum"].values())


def test_two_steps_from_a_carried_state_match_jax(world):
    state = port_bt.create_bisenet_train_state(
        device="cpu", state=world["carried"], **SCHED)
    step = port_bt.make_bisenet_train_step()
    for batch, (want, want_loss) in zip(world["batches"][1:],
                                        world["singles"]):
        state, m = step(state, *batch)
        _assert_state(state.model.state_dict(), state.optimizer.trace, want,
                      float(m["loss"]), want_loss)
    assert state.step == 3 and set(state.optimizer.count.values()) == {3}


def test_two_rank_syncbn_step_matches_jax_mesh(world):
    want, want_loss = world["mesh"]
    for r in world["ranks"]:
        _assert_state(r["state"], r["momentum"], want, r["loss"], want_loss)


def test_two_rank_syncbn_gradient_is_exact_in_fp64(world):
    """The 2-rank step run in fp64: its gradient (the first momentum trace,
    less the weight decay) against the same step's math in one process,
    in fp64: BatchNorm over all 8 images (the pmean of equal shards'
    means), the mean of the two ranks' OHEM losses. 1e-6 of each leaf's
    largest entry: the distributed math is the single-process math."""
    from consistentid_torch.io.from_jax import state_from_jax

    params, stats = _draw_state()
    images, labels = _batch(8, 9)
    model = port_bt.BiSeNet()
    model.load_state_dict(state_from_jax({"params": params,
                                          "batch_stats": stats}))
    model = model.double().train()
    outs = model.forward_nchw(
        torch.from_numpy(images).double().permute(0, 3, 1, 2))
    lab = torch.from_numpy(labels)
    loss = sum((port_bt.ohem_cross_entropy(o[:4], lab[:4])
                + port_bt.ohem_cross_entropy(o[4:], lab[4:])) / 2
               for o in outs)
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    for r in world["ranks"]:
        np.testing.assert_allclose(r["loss_fp64"], float(loss), rtol=1e-12)
        for k, g in grads.items():
            p = named[k].detach().numpy()
            got = r["momentum_fp64"][k] - (5e-4 * p if p.ndim > 1 else 0)
            err = np.abs(got - g.numpy()).max()
            assert err <= 1e-6 * np.abs(g.numpy()).max(), (k, err)


@pytest.mark.parametrize("n_min,ignored", [(None, True), (900, True),
                                           (None, False)])
def test_ohem_matches_jax(n_min, ignored):
    """Both branches: the default n_min (the n_min-th loss above the
    threshold: the mean over the threshold) and a large one, 900 of 960
    pixels (the top-n_min mean); ignored pixels count in n_pix with a zero
    loss."""
    rng = np.random.RandomState(3)
    logits = (rng.randn(2, 24, 20, 19) * 3).astype(np.float32)
    labels = rng.randint(0, 19, (2, 24, 20)).astype(np.int32)
    if ignored:
        labels[0, :6] = port_bt.IGNORE_LABEL
    want = float(jax.jit(jax_bt.ohem_cross_entropy, static_argnums=(2, 3))(
        logits, labels, 0.7, n_min))
    got = port_bt.ohem_cross_entropy(
        torch.from_numpy(logits).permute(0, 3, 1, 2),
        torch.from_numpy(labels), 0.7, n_min)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("lr0", [1e-2, 1e-1])
def test_schedule_matches_jax(lr0):
    kw = dict(lr0=lr0, warmup_steps=1000, warmup_start_lr=1e-5,
              max_iter=80000, power=0.9)
    want = jax_bt.warmup_poly_schedule(**kw)
    got = port_bt.warmup_poly_schedule(**kw)
    for s in (0, 1, 999, 1000, 1001, 40000, 80000):
        np.testing.assert_allclose(got(s), float(want(s)), rtol=2e-7,
                                   err_msg=str(s))
    assert got(0) == pytest.approx(1e-5)


def test_param_groups_match_jax_labels():
    params, _ = _draw_state()
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    want = {}
    for path, leaf in flat:
        keys = tuple(p.key for p in path)
        name = ".".join(keys[:-1] + ("weight" if keys[-1] in (
            "kernel", "scale") else keys[-1],))
        want[name] = jax_bt._param_group(keys)
    model = port_bt.BiSeNet()
    got = {n: port_bt.param_group(n, p) for n, p in model.named_parameters()}
    assert got == want
    assert set(got.values()) == set(port_bt.BiSeNetSGD.GROUPS)


# ------------------------------------------------------------ data, tools

def _png(path, arr):
    with open(path, "wb") as f:
        f.write(encode_png(arr))


@pytest.fixture(scope="module")
def faces(tmp_path_factory):
    """3 faces as PNG bytes under .jpg names (both sides read them) and
    their grey label maps, of assorted sizes."""
    root = tmp_path_factory.mktemp("faces")
    rng = np.random.RandomState(0)
    for i, (h, w) in enumerate([(60, 52), (40, 40), (72, 64)]):
        os.makedirs(root / "images", exist_ok=True)
        os.makedirs(root / "labels", exist_ok=True)
        _png(root / "images" / f"{i}.jpg",
             rng.randint(0, 255, (h, w, 3), np.uint8))
        _png(root / "labels" / f"{i}.png",
             rng.randint(0, 19, (h, w), np.uint8))
    return root


def test_face_mask_dataset_draws_match_jax(faces):
    args = (str(faces / "images"), str(faces / "labels"))
    want = jax_bt.FaceMaskDataset(*args, crop=96, seed=5)
    got = port_bt.FaceMaskDataset(*args, crop=96, seed=5)
    assert got.names == want.names
    for i in (0, 2):
        (wx, wy), (gx, gy) = want[i], got[i]
        np.testing.assert_array_equal(gy, wy)
        np.testing.assert_allclose(gx, wx, rtol=0, atol=1e-6)
    (wx, wy), (gx, gy) = next(want.batches(2)), next(got.batches(2))
    np.testing.assert_array_equal(gy, wy)
    np.testing.assert_allclose(gx, wx, rtol=0, atol=1e-6)


def test_preprocess_matches_jax(tmp_path):
    rng = np.random.RandomState(1)
    folder = tmp_path / "masks" / "0"
    os.makedirs(folder)
    for idx in (0, 2):
        for part in ("skin", "nose", "hair", "u_lip"):
            m = np.where(rng.rand(512, 512) < 0.3, 255, 0).astype(np.uint8)
            m[rng.rand(512, 512) < 0.05] = 225
            if part == "hair":   # an RGB mask: convert("L") on both sides
                m = np.stack([m, m // 2, m], -1)
            _png(folder / f"{idx:05d}_{part}.png", m)
    jax_tools.run_preprocess_celeba(str(tmp_path / "masks"),
                                    str(tmp_path / "jax"), num_images=3)
    port_tools.main(["preprocess", "--mask-root", str(tmp_path / "masks"),
                     "--out", str(tmp_path / "port"), "--num-images", "3"])
    assert sorted(os.listdir(tmp_path / "port")) == ["0.png", "2.png"]
    for name in ("0.png", "2.png"):
        np.testing.assert_array_equal(
            read_array(str(tmp_path / "port" / name))[:, :, 0],
            np.asarray(Image.open(tmp_path / "jax" / name)))


def test_recolor_matches_jax():
    rng = np.random.RandomState(2)
    image = rng.randint(0, 255, (32, 32, 3), np.uint8)
    labels = rng.randint(0, 19, (32, 32)).astype(np.uint8)
    for part in ("hair", "upper_lip", "lower_lip"):
        np.testing.assert_array_equal(
            port_tools.recolor(image, labels, part, (30, 30, 160)),
            jax_tools.recolor(image, labels, part, (30, 30, 160)))


def _labeler(x):
    """A stand-in parser for both sides: labels from the preprocessed
    pixels, so equal inputs give equal labels."""
    x = np.asarray(x)
    return (np.floor(np.abs(x).sum(-1) * 5) % 19).astype(np.uint8)


def test_evaluate_and_makeup_match_jax(faces, tmp_path, monkeypatch):
    """The tools' reading, BICUBIC resize, batching with zero padding,
    overlays and recolouring, with one stand-in parser on both sides (the
    BiSeNet forward itself is tests/test_torch_perception.py's)."""
    monkeypatch.setattr(jax_tools, "_parser_fn", lambda *a, **k: _labeler)
    monkeypatch.setattr(port_tools, "_parser_fn", lambda *a, **k: _labeler)
    images = str(faces / "images")
    jax_tools.run_evaluate(images, str(tmp_path / "jax"), "-", batch=2)
    port_tools.run_evaluate(images, str(tmp_path / "port"), "-", batch=2)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == ["0_parsed.png", "1_parsed.png", "2_parsed.png"]
    for name in names:
        np.testing.assert_array_equal(
            read_array(str(tmp_path / "port" / name)),
            np.asarray(Image.open(tmp_path / "jax" / name)))
    face = str(faces / "images" / "0.jpg")
    jax_tools.run_makeup(face, str(tmp_path / "jax.png"), "-")
    port_tools.run_makeup(face, str(tmp_path / "port.png"), "-")
    np.testing.assert_array_equal(read_array(str(tmp_path / "port.png")),
                                  np.asarray(Image.open(tmp_path /
                                                        "jax.png")))


def test_tools_parse_with_the_checkpoint(faces, tmp_path):
    """The port's tools read a face_parsing checkpoint (written by the
    port's exporter) and parse as models.bisenet.make_face_parser does."""
    from consistentid_torch.io.export_backbones import bisenet_to_torch
    from consistentid_torch.io.from_jax import state_from_jax
    from consistentid_torch.io.safetensors_reader import write_safetensors
    from consistentid_torch.models.bisenet import make_face_parser

    params, stats = _draw_state()
    path = str(tmp_path / "face_parsing.safetensors")
    write_safetensors(path, bisenet_to_torch(params, stats))
    face = str(faces / "images" / "1.jpg")
    port_tools.main(["makeup", "--image", face, "--out",
                     str(tmp_path / "m.png"), "--bisenet", path,
                     "--device", "cpu"])
    parse = make_face_parser(state_from_jax(
        {"params": params, "batch_stats": stats}), device="cpu")
    image = port_tools._read_resized(face, 512)
    labels = parse(image)
    want = image
    for part, color in (("hair", (30, 30, 160)), ("upper_lip", (160, 30, 60)),
                        ("lower_lip", (160, 30, 60))):
        want = port_tools.recolor(want, labels, part, color)
    np.testing.assert_array_equal(read_array(str(tmp_path / "m.png")), want)
