"""The port's checkpoint loading against the JAX package's, on the CPU:
reference-layout files written by the JAX package's
`apps.validate.synthesize` (tiny configs, random weights), read by both
readers and loaded by both loaders; the port's exporters against the JAX
exporters; export then load round trips of the port's own tiny bundle.

`fast_synthesize` runs `synthesize` with flax's `Module.init` replaced by
numpy draws in the shapes `jax.eval_shape` gives (no JAX compile), as the
perception tests draw their parameters; the other port test files that need
the files import it."""
import contextlib
import os

import numpy as np
import pytest
import torch

import jax
from safetensors.numpy import load_file as st_load_file

from consistentid_tpu.apps import validate as jax_validate
from consistentid_tpu.io import convert as jax_convert
from consistentid_tpu.io import export_backbones as jax_exp
from consistentid_tpu.io.convert_backbones import \
    safety_checker_from_hf as jax_sc_from_hf
from consistentid_tpu.io.onnx_reader import \
    read_onnx_initializers as jax_read_onnx
from consistentid_tpu.io.safetensors_reader import \
    read_checkpoint as jax_read_checkpoint
from consistentid_tpu.pipelines.loading import \
    _safety_checker_vision_config as jax_sc_config
from consistentid_tpu.pipelines.loading import \
    load_sd15_consistentid as jax_load_sd15
from consistentid_tpu.pipelines import SD15Bundle as JaxSD15Bundle
from consistentid_tpu.testing import tiny_bundle as jax_tiny_bundle
from consistentid_torch.apps import validate as port_validate
from consistentid_torch.conditioning import CLIPBPETokenizer
from consistentid_torch.io import convert, export_backbones as exp
from consistentid_torch.io import params_from_jax, state_from_jax
from consistentid_torch.io.from_jax import tree_from_module
from consistentid_torch.io.onnx_reader import read_onnx_initializers
from consistentid_torch.io.safetensors_reader import (read_checkpoint,
                                                      write_safetensors)
from consistentid_torch.pipelines.loading import (load_face_stack,
                                                  load_sd15_consistentid)
from consistentid_torch.testing import tiny_bundle


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny CPU models run as many small torch ops; in a parallel test
    run, each worker's intra-op threads would oversubscribe the cores and
    slow every op many times over. The other port test files that import
    it use it too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(rng, path, x):
    name = jax.tree_util.keystr(path[-1:])
    if "kernel" in name:
        fan_in = int(np.prod(x.shape[:-1]))
        return (rng.standard_normal(x.shape) / np.sqrt(fan_in)).astype(
            x.dtype)
    if "'var'" in name:
        return rng.uniform(0.5, 1.5, x.shape).astype(x.dtype)
    if "scale" in name:
        return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
    if "alpha" in name:
        return np.full(x.shape, 0.25, x.dtype)
    return (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)


@contextlib.contextmanager
def fast_flax_init(seed: int = 0):
    """flax Module.init -> numpy draws in its output's shapes, seeded by
    `seed` and the init's key (the same init twice gives the same
    draws, as flax's does)."""
    import flax.linen as nn

    orig = nn.Module.init

    def init(self, rngs, *args, **kwargs):
        shapes = jax.eval_shape(lambda: orig(self, rngs, *args, **kwargs))
        rng = np.random.default_rng(
            [seed, *np.asarray(rngs).ravel().tolist()])
        return jax.tree_util.tree_map_with_path(
            lambda p, x: _draw(rng, p, x), shapes)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", init)
        yield


def tiny_tree_shapes(jbundle):
    """The tree of `jbundle.init_params` (the JAX tiny SD1.5 bundle), its
    leaves read off the port's tiny bundle: the same leaves at the same
    shapes, flattened in the same order (`params_from_jax` loads one into
    the other strictly), without tracing flax's init (4.5 s a call on
    this CPU against 0.5 s). Numpy draws over it give the draws over
    `jax.eval_shape(jbundle.init_params, ...)` bit for bit."""
    import dataclasses

    port = tiny_bundle(device="cpu")
    for name in ("unet_config", "adapter_config", "vae_config",
                 "text_config", "vision_config"):
        theirs, ours = (dataclasses.asdict(getattr(b, name))
                        for b in (jbundle, port))
        assert all(theirs[k] == ours[k] for k in ours), name
    return tree_from_module(port)[0]


def fast_synthesize(outdir: str):
    """`apps.validate.synthesize` with fast_flax_init: the same files, the
    weights drawn by numpy."""
    with fast_flax_init():
        return jax_validate.synthesize(outdir)


@pytest.fixture(scope="module")
def synth_and_init(tmp_path_factory):
    """The JAX package's set, and the tree of the tiny SD1.5 bundle's
    `init_params` call that writing it makes (its flax inits traced,
    leaves drawn by numpy in their shapes) with that bundle."""
    inits = []
    real = JaxSD15Bundle.init_params

    def init_params(self, *args, **kwargs):
        tree = real(self, *args, **kwargs)
        if type(self) is JaxSD15Bundle:
            inits.append((self, tree))
        return tree

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxSD15Bundle, "init_params", init_params)
        paths = fast_synthesize(str(tmp_path_factory.mktemp("synth")))
    assert len(inits) == 1
    return paths, inits[0]


@pytest.fixture(scope="module")
def synth(synth_and_init):
    return synth_and_init[0]


def test_tiny_tree_shapes_equal_jax_init_tree(synth_and_init):
    """`tiny_tree_shapes` against the tree of the JAX init it stands in
    for: the same leaf paths in the same order, shapes and dtypes, so a
    leaf that only one package has shows here."""
    jbundle, tree = synth_and_init[1]

    def leaves(tree):
        return [(jax.tree_util.keystr(p), tuple(np.shape(x)),
                 np.dtype(x.dtype))
                for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]

    assert leaves(tiny_tree_shapes(jbundle)) == leaves(tree)


FILES = ["sd15/unet", "sd15/vae", "sd15/text_encoder", "sd15/safety_checker",
         "image_encoder.safetensors", "ConsistentID-v1.bin",
         "face_parsing.pth", "arcface.pt", "scrfd.pt", "arcface.onnx",
         "sdxl/text_encoder_2/model.safetensors"]


def _root(synth):
    return os.path.dirname(synth["base"])


def _assert_dicts_equal(got, want, where=""):
    assert set(got) == set(want), (where, set(got) ^ set(want))
    for k in want:
        if isinstance(want[k], dict):
            _assert_dicts_equal(got[k], want[k], f"{where}{k}.")
            continue
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (where + k,
                                                           g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=where + k)


@pytest.mark.parametrize("rel", FILES)
def test_read_checkpoint_matches_jax_reader(synth, rel):
    """Bit for bit, safetensors (dirs and files), .bin sections, .pth, .pt
    and .onnx."""
    path = os.path.join(_root(synth), rel)
    got = read_checkpoint(path)
    _assert_dicts_equal(got, jax_read_checkpoint(path))
    if path.endswith(".safetensors"):
        _assert_dicts_equal(got, st_load_file(path))
    if path.endswith(".onnx"):
        _assert_dicts_equal(read_onnx_initializers(path),
                            jax_read_onnx(path))


def test_write_safetensors_read_by_the_package(tmp_path):
    """The port's writer against the safetensors package, which also
    writes the bf16 the port's reader widens."""
    from safetensors.torch import save_file as st_torch_save

    rng = np.random.default_rng(0)
    tensors = {"a.weight": rng.standard_normal((3, 5)).astype(np.float16),
               "b": rng.standard_normal(7).astype(np.float32),
               "c": np.arange(6, dtype=np.int64).reshape(2, 3)}
    path = str(tmp_path / "x.safetensors")
    n = write_safetensors(path, tensors)
    assert n == os.path.getsize(path)
    _assert_dicts_equal(st_load_file(path), tensors)
    _assert_dicts_equal(read_checkpoint(path), tensors)
    bf = torch.randn(4, 6).to(torch.bfloat16)
    st_torch_save({"w": bf}, str(tmp_path / "bf.safetensors"))
    got = read_checkpoint(str(tmp_path / "bf.safetensors"))["w"]
    np.testing.assert_array_equal(got, bf.float().numpy())


def test_tokenizer_from_pretrained_matches_jax(synth):
    from consistentid_tpu.conditioning import \
        CLIPBPETokenizer as JaxTokenizer
    tok_dir = os.path.join(synth["base"], "tokenizer")
    got, want = (CLIPBPETokenizer.from_pretrained(tok_dir),
                 JaxTokenizer.from_pretrained(tok_dir))
    text = "a Photo of a man, <|facial|> smiling!"
    for t in (got, want):
        t.add_tokens(["<|image|>", "<|facial|>"])
    assert got.encode(text) == want.encode(text)
    assert got.pad_token_id == want.pad_token_id


@pytest.fixture(scope="module")
def loaded(synth):
    kw = dict(consistentid_path=synth["consistentid"],
              image_encoder_path=synth["image_encoder"],
              bisenet_path=synth["bisenet"], arcface_path=synth["arcface"],
              scrfd_path=synth["scrfd"])
    port = load_sd15_consistentid(synth["base"],
                                  bundle=tiny_bundle(device="cpu"),
                                  device="cpu", **kw)
    with fast_flax_init(seed=1):
        want = jax_load_sd15(synth["base"], bundle=jax_tiny_bundle(),
                             dtype=jax.numpy.float32, **kw)
    return port, want


def test_load_sd15_matches_jax_loader(loaded):
    """Every leaf of the bundle, fp32, exact: the two loaders' init trees
    differ (the JAX one is drawn by numpy here), so equality means every
    leaf came from the files in both."""
    port, want = loaded
    want_state = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        want.params))
    got_state = port.bundle.state_dict()
    assert set(got_state) == set(want_state)
    for k, w in want_state.items():
        torch.testing.assert_close(got_state[k], w, rtol=0, atol=0,
                                   msg=k)


def _assert_state_equal(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        assert torch.equal(got[k].cpu(), w), k


def test_face_stack_and_checker_match_jax_converters(synth, loaded):
    """The parser, embedder, detector and safety checker states: the JAX
    loader's converters on the same files, carried by state_from_jax."""
    port, _ = loaded
    params, stats = jax_convert.bisenet_from_torch(
        jax_read_checkpoint(synth["bisenet"]))
    _assert_state_equal(port.face_parser.model.state_dict(),
                        state_from_jax({"params": params,
                                        "batch_stats": stats}))
    params, stats = jax_convert.iresnet_from_torch(
        jax_read_checkpoint(synth["arcface"]))
    _assert_state_equal(port.face_embedder.model.state_dict(),
                        state_from_jax({"params": params,
                                        "batch_stats": stats},
                                       flatten_nhwc={"fc": 512}))
    params, stats, _ = jax_convert.scrfd_from_torch(
        jax_read_checkpoint(synth["scrfd"]))
    _assert_state_equal(port.face_embedder.detector.model.state_dict(),
                        state_from_jax({"params": params,
                                        "batch_stats": stats}))
    sc_dir = synth["safety_checker"]
    _assert_state_equal(
        port.safety_checker.model.state_dict(),
        params_from_jax(jax_sc_from_hf(jax_read_checkpoint(sc_dir),
                                       jax_sc_config(sc_dir))))


def test_load_face_stack_reads_onnx_embedder(synth, loaded):
    """The ONNX twin of arcface.pt loads the same embedder state."""
    parser, embedder = load_face_stack(
        arcface_path=os.path.join(_root(synth), "arcface.onnx"),
        device="cpu")
    assert parser is None
    _assert_state_equal(embedder.model.state_dict(),
                        loaded[0].face_embedder.model.state_dict())


# -------------------------------------------------- port exporters, round trip

def _tiny_perception(seed: int):
    """Tiny port perception models with seeded random weights: BiSeNet,
    iresnet (1, 1, 1, 1) at 32 px, SCRFD "tiny", a safety checker on the
    tiny bundle's vision tower."""
    from consistentid_torch.models.arcface import IResNet
    from consistentid_torch.models.bisenet import BiSeNet
    from consistentid_torch.models.safety_checker import SafetyChecker
    from consistentid_torch.models.scrfd import SCRFD, SCRFD_VARIANTS
    from consistentid_torch.testing import randomize_perception_module

    gen = torch.Generator().manual_seed(seed)
    models = {"parser": BiSeNet(19),
              "embedder": IResNet((1, 1, 1, 1), 16, 32),
              "detector": SCRFD(SCRFD_VARIANTS["tiny"]),
              "safety_checker": SafetyChecker(
                  tiny_bundle(device="cpu").vision_config,
                  projection_dim=16, num_concepts=3, num_special=2)}
    for m in models.values():
        randomize_perception_module(m, gen)
    return models


def test_export_then_load_roundtrips_the_port_bundle(tmp_path):
    """The port's tiny bundle and perception models, written as a
    reference-layout set (fp32) and loaded into fresh models: every tensor
    back exactly."""
    from consistentid_torch.io.export import write_reference_checkpoints
    from consistentid_torch.testing import synthetic_clip_tokenizer

    src = tiny_bundle(device="cpu", seed=3)
    src.random_params(torch.Generator().manual_seed(3))
    models = _tiny_perception(4)
    paths, nbytes = write_reference_checkpoints(
        str(tmp_path), src, vocab=synthetic_clip_tokenizer().encoder,
        dtype=np.float32, **models)
    assert nbytes > 0
    base = paths.pop("base")
    pipe = load_sd15_consistentid(base, bundle=tiny_bundle(device="cpu"),
                                  device="cpu", **paths)
    _assert_state_equal(pipe.bundle.state_dict(), src.state_dict())
    _assert_state_equal(pipe.face_parser.model.state_dict(),
                        models["parser"].state_dict())
    _assert_state_equal(pipe.face_embedder.model.state_dict(),
                        models["embedder"].state_dict())
    _assert_state_equal(pipe.face_embedder.detector.model.state_dict(),
                        models["detector"].state_dict())
    _assert_state_equal(pipe.safety_checker.model.state_dict(),
                        models["safety_checker"].state_dict())
    assert isinstance(pipe.tokenizer, CLIPBPETokenizer)


@pytest.fixture(scope="module")
def jax_tree():
    with fast_flax_init(seed=2):
        return jax_tiny_bundle().init_params(jax.random.PRNGKey(0))


@pytest.mark.parametrize("part", ["unet", "vae", "text_encoder",
                                  "image_encoder", "consistentid"])
def test_port_exporters_match_jax_on_the_bundle(jax_tree, part):
    """The same JAX-drawn tree through the JAX exporter, and through the
    port bundle, `tree_from_module` and the port's exporter."""
    jb = jax_tiny_bundle()
    port = tiny_bundle(device="cpu")
    port.load_state_dict(params_from_jax(jax_tree), strict=True)
    jexp = {"unet": lambda t: jax_exp.unet_to_diffusers(t["unet"],
                                                        jb.unet_config),
            "vae": lambda t: jax_exp.vae_to_diffusers(t["vae"],
                                                      jb.vae_config),
            "text_encoder": lambda t: jax_exp.clip_text_to_hf(
                t["text_encoder"], jb.text_config),
            "image_encoder": lambda t: jax_exp.clip_vision_to_hf(
                t["image_encoder"], jb.vision_config),
            "consistentid": lambda t: jax_convert.
            export_consistentid_checkpoint(t, jb.unet_config, 4, 2)}
    pexp = {"unet": lambda t: exp.unet_to_diffusers(t["unet"],
                                                    port.unet_config),
            "vae": lambda t: exp.vae_to_diffusers(t["vae"],
                                                  port.vae_config),
            "text_encoder": lambda t: exp.clip_text_to_hf(
                t["text_encoder"], port.text_config),
            "image_encoder": lambda t: exp.clip_vision_to_hf(
                t["image_encoder"], port.vision_config),
            "consistentid": lambda t: convert.
            export_consistentid_checkpoint(t, port.unet_config, 4, 2)}
    want = jexp[part](jax.tree_util.tree_map(np.asarray, jax_tree))
    _assert_dicts_equal(pexp[part](tree_from_module(port)[0]), want)


@pytest.mark.parametrize("part", ["parser", "embedder", "detector",
                                  "safety_checker"])
def test_port_exporters_match_jax_on_perception(part):
    """Port perception weights through `tree_from_module` and the port's
    exporter against the JAX exporter on the same variables."""
    from consistentid_torch.models.scrfd import SCRFD_VARIANTS

    model = _tiny_perception(5)[part]
    kw = {"flatten_nhwc": {"fc": 512}} if part == "embedder" else {}
    params, stats = tree_from_module(model, **kw)
    _assert_state_equal(state_from_jax({"params": params,
                                        "batch_stats": stats}, **kw),
                        model.state_dict())
    cfg = SCRFD_VARIANTS["tiny"]
    port_fn = {"parser": lambda p, s: exp.bisenet_to_torch(p, s),
               "embedder": lambda p, s: exp.iresnet_to_torch(
                   p, s, layers=(1, 1, 1, 1), spatial=2),
               "detector": lambda p, s: exp.scrfd_to_torch(p, s, cfg),
               "safety_checker": lambda p, s: exp.safety_checker_to_hf(
                   p, model.vision_config)}[part]
    jax_fn = {"parser": lambda p, s: jax_exp.bisenet_to_torch(p, s),
              "embedder": lambda p, s: jax_exp.iresnet_to_torch(
                  p, s, layers=(1, 1, 1, 1), spatial=2),
              "detector": lambda p, s: jax_exp.scrfd_to_torch(p, s, cfg),
              "safety_checker": lambda p, s: jax_exp.safety_checker_to_hf(
                  p, model.vision_config)}[part]
    _assert_dicts_equal(port_fn(params, stats), jax_fn(params, stats))


def test_load_consistentid_checkpoint_matches_jax(synth, jax_tree):
    """The port's merge of ConsistentID-v1.bin into a bundle tree against
    the JAX package's, every leaf exact; an unknown target raises."""
    sd = read_checkpoint(synth["consistentid"])
    cfg = jax_tiny_bundle().unet_config
    tree = jax.tree_util.tree_map(np.asarray, jax_tree)
    _assert_dicts_equal(convert.load_consistentid_checkpoint(tree, sd, cfg),
                        jax_convert.load_consistentid_checkpoint(
                            tree, jax_read_checkpoint(synth["consistentid"]),
                            cfg))
    del tree["unet"]["mid_attn"]
    with pytest.raises(KeyError, match="unknown adapter target"):
        convert.load_consistentid_checkpoint(tree, sd, cfg)


SCALAR = {(1,): ()}


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


def test_port_synthesize_writes_the_jax_set(synth, tmp_path):
    """The port's `apps.validate.synthesize` (its exporters) writes the
    JAX package's relative file list; per checkpoint file the same keys
    and shapes; the tokenizer and config files the same bytes. Scalars
    (BatchNorm counters, SCRFD's box scales) are one element either way:
    the JAX writer's np.ascontiguousarray gives a 0-d array one dimension,
    so its torch files hold them as (1,); torch's own state dicts and the
    port's files as ()."""
    port_paths = port_validate.synthesize(str(tmp_path / "port"))
    port_root = os.path.dirname(port_paths["base"])
    jax_root = _root(synth)
    assert set(port_paths) == set(synth)
    names = _files(jax_root)
    assert _files(port_root) == names
    for name in names:
        ours, theirs = (os.path.join(r, name) for r in (port_root, jax_root))
        if name.endswith((".json", ".txt")):
            with open(ours) as f, open(theirs) as g:
                assert f.read() == g.read(), name
            continue
        got, want = read_checkpoint(ours), jax_read_checkpoint(theirs)
        assert set(got) == set(want), name
        for k in want:
            if isinstance(want[k], dict):
                assert {n: v.shape for n, v in got[k].items()} == \
                    {n: v.shape for n, v in want[k].items()}, (name, k)
            else:
                assert got[k].shape in {want[k].shape, SCALAR.get(
                    want[k].shape)}, (name, k)
