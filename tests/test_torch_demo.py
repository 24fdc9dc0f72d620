"""The port's gradio demo (consistentid_torch.apps.demo) against the JAX
package's (consistentid_tpu.apps.demo) on the CPU. gradio is installed
neither here nor on the card's machine, so both interfaces are built
under one stand-in `gradio` module that records the widgets it is asked
for: the same widgets, labels, ranges and defaults, but for the input
image's type (numpy in the port, PIL in JAX); the same `generate`
arguments for the same widget values; one request end to end on the tiny
bundle with injected latents (the one JAX compile of this file); the
parser's honoured and refused flags; `main` without gradio."""
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from consistentid_tpu.apps import demo as jax_demo
from consistentid_tpu.core import PipelineConfig as JaxPipelineConfig
from consistentid_tpu.pipelines import ConsistentIDPipeline as JaxPipeline
from consistentid_tpu.testing import synthetic_clip_tokenizer as jax_tokenizer
from consistentid_tpu.testing import tiny_bundle as jax_tiny_bundle
from consistentid_torch.apps import demo, infer
from consistentid_torch.core import PipelineConfig
from consistentid_torch.io import params_from_jax
from consistentid_torch.pipelines import ConsistentIDPipeline
from consistentid_torch.testing import synthetic_clip_tokenizer, tiny_bundle
from test_torch_loading import one_torch_thread  # noqa: F401
from test_torch_pipeline import _bundle_params, face_inputs

# test_torch_pipeline's request: 3 DDIM steps across the merge step at 1
PROMPT = "portrait photo of a man with a strong face, blue eyes and a nose"
STEPS, MERGE, GUIDANCE, SEED = 3, 1, 5.0, 2024


class _Widget:
    def __init__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs

    def described(self):
        return type(self).__name__, self.args, dict(self.kwargs)


def stand_in_gradio():
    """A `gradio` module that only records: each widget its arguments,
    each Interface itself (in `interfaces`), and `launch` its keywords."""
    gr = types.ModuleType("gradio")
    gr.interfaces = []
    for name in ("Image", "Textbox", "Slider", "Number"):
        setattr(gr, name, type(name, (_Widget,), {}))

    class Interface(_Widget):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.launched = None
            gr.interfaces.append(self)

        def launch(self, **kwargs):
            self.launched = kwargs

    gr.Interface = Interface
    return gr


def _interface(module, pipe, monkeypatch):
    gr = stand_in_gradio()
    monkeypatch.setitem(sys.modules, "gradio", gr)
    iface = module.build_interface(pipe)
    assert gr.interfaces == [iface]
    return iface


def test_interface_matches_jax(monkeypatch):
    port = _interface(demo, object(), monkeypatch)
    ref = _interface(jax_demo, object(), monkeypatch)
    got = [w.described() for w in port.kwargs["inputs"]]
    want = [w.described() for w in ref.kwargs["inputs"]]
    # the one deliberate difference: the face reaches the callback as a
    # numpy (H, W, 3) uint8 array, the port's image form
    assert got[0][2].pop("type") == "numpy"
    assert want[0][2].pop("type") == "pil"
    assert got == want and len(got) == 7
    assert (port.kwargs["outputs"].described()
            == ref.kwargs["outputs"].described())
    assert set(port.kwargs) == set(ref.kwargs) == {"fn", "inputs",
                                                   "outputs", "title"}
    assert port.kwargs["title"] == demo.TITLE != ref.kwargs["title"]
    assert "PyTorch" in demo.TITLE


class RecordingPipe:
    def __init__(self):
        self.calls = []
        self.images = np.arange(2 * 4 * 5 * 3, dtype=np.uint8).reshape(
            2, 4, 5, 3)

    def generate(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        return self.images


def test_callback_passes_jax_arguments(monkeypatch):
    """Widget values as gradio sends them (sliders and the seed as
    floats): both callbacks cast them alike and return generate's first
    image."""
    face = face_inputs()[0]
    widgets = (PROMPT, "blurry", 7.0, 3.0, 4.5, 11.0)
    port_pipe, jax_pipe = RecordingPipe(), RecordingPipe()
    got = _interface(demo, port_pipe, monkeypatch).kwargs["fn"](
        face, *widgets)
    want = _interface(jax_demo, jax_pipe, monkeypatch).kwargs["fn"](
        Image.fromarray(face), *widgets)
    np.testing.assert_array_equal(got, port_pipe.images[0])
    np.testing.assert_array_equal(want, jax_pipe.images[0])
    (port_args, port_kw), = port_pipe.calls
    (jax_args, jax_kw), = jax_pipe.calls
    assert port_args[0] == jax_args[0] == PROMPT
    np.testing.assert_array_equal(port_args[1], face)
    np.testing.assert_array_equal(np.asarray(jax_args[1]), face)
    assert port_kw == jax_kw == dict(
        negative_prompt="blurry", num_inference_steps=7, start_merge_step=3,
        guidance_scale=4.5, seed=11)
    assert [type(port_kw[k]) for k in sorted(port_kw)] == \
        [type(jax_kw[k]) for k in sorted(jax_kw)]
    # the module-level callback is the interface's
    assert demo.demo_callback(port_pipe)(face, *widgets).shape == (4, 5, 3)


def test_request_end_to_end_matches_jax(monkeypatch):
    """One request through each demo's callback on the tiny bundle (the
    same numpy parameters, carried by params_from_jax), faces parsed and
    embedded by the same stub hooks, the initial latents injected into
    both (each pipeline's own draw replaced), at 3 DDIM steps: the
    decoded images within test_torch_pipeline's 1e-3 on [-1, 1], so the
    uint8 images within one grey level."""
    face, labels, faceid = face_inputs()
    latents = np.random.default_rng(7).standard_normal((1, 32, 32, 4),
                                                       np.float32)
    jbundle = jax_tiny_bundle()
    params = _bundle_params(jbundle)
    config = dict(height=64, width=64)
    seen = []

    def parser(image):
        seen.append(np.asarray(image))
        return labels

    def embedder(image):
        return faceid

    jpipe = JaxPipeline(jbundle, params, jax_tokenizer(),
                        pipeline_config=JaxPipelineConfig(**config),
                        face_parser=parser, face_embedder=embedder)
    pbundle = tiny_bundle(device="cpu")
    pbundle.load_state_dict(params_from_jax(params), strict=True)
    ppipe = ConsistentIDPipeline(pbundle, synthetic_clip_tokenizer(),
                                 pipeline_config=PipelineConfig(**config),
                                 face_parser=parser, face_embedder=embedder)

    floats = {}
    jax_core = jpipe._core_jit

    def jax_injected(params, cond, drawn, *rest):
        assert drawn.shape == latents.shape
        out = jax_core(params, cond, jnp.asarray(latents), *rest)
        floats["jax"] = np.asarray(out)
        return out

    port_run = ppipe._run

    def port_injected(cond, drawn, *rest, **kw):
        assert tuple(drawn.shape) == latents.shape
        out = port_run(cond, torch.from_numpy(latents), *rest, **kw)
        floats["port"] = out.numpy()
        return out

    monkeypatch.setattr(jpipe, "_core_jit", jax_injected)
    monkeypatch.setattr(ppipe, "_run", port_injected)
    widgets = (PROMPT, "", float(STEPS), float(MERGE), GUIDANCE, float(SEED))
    got = _interface(demo, ppipe, monkeypatch).kwargs["fn"](face, *widgets)
    want = _interface(jax_demo, jpipe, monkeypatch).kwargs["fn"](
        Image.fromarray(face), *widgets)

    assert len(seen) == 2
    np.testing.assert_array_equal(seen[0], seen[1])
    assert floats["port"].shape == floats["jax"].shape == (1, 64, 64, 3)
    np.testing.assert_allclose(floats["port"], floats["jax"], rtol=0,
                               atol=1e-3)
    assert got.shape == want.shape == (64, 64, 3)
    assert got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert got.std() > 1.0


BASE = ["--base", "sd15", "--bisenet", "face_parsing.pth"]


def test_main_without_gradio_exits_naming_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)   # import fails
    with pytest.raises(SystemExit) as e:
        demo.main(BASE)
    assert "gradio" in str(e.value)
    assert "consistentid_torch.apps.infer" in str(e.value)


def test_main_honours_its_flags(monkeypatch):
    """The flags the demo honours reach the loader (infer.load_pipeline);
    the defaults are PipelineConfig's (ddim, 512 x 512, 50 steps, merge
    30, CFG 5), the JAX demo's; the interface launches on --port and main
    returns the pipeline."""
    gr = stand_in_gradio()
    monkeypatch.setitem(sys.modules, "gradio", gr)
    loaded = []

    def load_pipeline(args):
        loaded.append(args)
        return RecordingPipe()

    monkeypatch.setattr(infer, "load_pipeline", load_pipeline)
    pipe = demo.main(BASE)
    assert gr.interfaces[-1].launched == {"server_port": 7860}
    args = loaded[-1]
    assert (args.scheduler, args.height, args.width, args.steps,
            args.start_merge_step, args.guidance_scale, args.device,
            args.quant, args.cache_interval, args.no_safety_checker,
            args.tiny) == ("ddim", 512, 512, 50, 30, 5.0, "cuda", "none", 1,
                           False, False)
    assert isinstance(pipe, RecordingPipe)

    pipe = demo.main(BASE + [
        "--consistentid", "c.bin", "--image-encoder", "e.safetensors",
        "--arcface", "a.onnx", "--scrfd", "s.onnx", "--tokenizer", "tok",
        "--no-safety-checker", "--device", "cpu", "--tiny", "--scheduler",
        "euler", "--height", "64", "--width", "48", "--port", "8123"])
    args = loaded[-1]
    assert gr.interfaces[-1].launched == {"server_port": 8123}
    assert (args.consistentid, args.image_encoder, args.bisenet,
            args.arcface, args.scrfd, args.tokenizer, args.no_safety_checker,
            args.device, args.tiny, args.scheduler, args.height,
            args.width) == ("c.bin", "e.safetensors", "face_parsing.pth",
                            "a.onnx", "s.onnx", "tok", True, "cpu", True,
                            "euler", 64, 48)


@pytest.mark.parametrize("flags, named", [
    (["--base", "sd15"], "--bisenet"),
    (["--prompt", "a man"], "--prompt"),
    (["--image", "face.png"], "--image"),
    (["--negative-prompt", "blurry"], "--negative-prompt"),
    (["--steps", "20"], "--steps"),
    (["--start-merge-step", "10"], "--start-merge-step"),
    (["--guidance-scale", "7"], "--guidance-scale"),
    (["--seed", "3"], "--seed"),
    (["--num-images", "2"], "--num-images"),
    (["--out", "x.png"], "--out"),
    (["--sdxl"], "--sdxl"),
    (["--tokenizer-2", "tok2"], "--tokenizer-2"),
    (["--init-image", "a.png"], "--init-image"),
    (["--mask-image", "m.png"], "--mask-image"),
    (["--strength", "0.5"], "--strength"),
    (["--quant", "int8"], "--quant"),
    (["--act-scales", "s.npz"], "--act-scales"),
    (["--save-act-scales", "s.npz"], "--save-act-scales"),
    (["--cache-interval", "2"], "--cache-interval"),
    (["--ip-scale", "0.5"], "--ip-scale"),
    (["--lora-scale", "0.5"], "--lora-scale"),
])
def test_parser_refuses_what_the_demo_cannot_honour(flags, named, capsys,
                                                    monkeypatch):
    """Each refused flag exits through the parser, naming itself, before
    gradio is looked for or anything is loaded (the JAX demo accepts them
    all and drops them)."""
    monkeypatch.setitem(sys.modules, "gradio", stand_in_gradio())
    argv = flags if flags[0] == "--base" else BASE + flags
    with pytest.raises(SystemExit) as e:
        demo.main(argv)
    assert e.value.code == 2
    assert named in capsys.readouterr().err
