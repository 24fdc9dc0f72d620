"""The port's five samplers against the JAX package's on the CPU: every
SamplerPlan table (and plan_tail's), `denoise` with a cheap stand-in UNet
in fp32 (DDPM with the JAX package's own noise draws injected), and
`generate_batch`'s stacked conditioning and per-request seeds."""
import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from consistentid_tpu.core import SchedulerConfig as JaxSchedulerConfig
from consistentid_tpu.pipelines import ConsistentIDPipeline as JaxPipeline
from consistentid_tpu.sampling import denoise as jax_denoise
from consistentid_tpu.sampling import schedulers as jax_sched
from consistentid_tpu.sampling.sampler import CondBranch as JaxBranch
from consistentid_tpu.testing import synthetic_clip_tokenizer as jax_tokenizer
from consistentid_tpu.testing import tiny_bundle as jax_tiny_bundle
from consistentid_torch.core import PipelineConfig, SchedulerConfig
from consistentid_torch.pipelines import ConsistentIDPipeline
from consistentid_torch.sampling import CondBranch, denoise
from consistentid_torch.sampling import schedulers as port_sched
from consistentid_torch.testing import synthetic_clip_tokenizer, tiny_bundle
from test_torch_loading import one_torch_thread  # noqa: F401

SAMPLERS = ["ddim", "euler", "ddpm", "dpmpp_2m", "pndm"]
PORT_SCHEDULE = port_sched.NoiseSchedule.create(SchedulerConfig())
JAX_SCHEDULE = jax_sched.NoiseSchedule.create(JaxSchedulerConfig())


def _assert_plans_equal(got, want):
    """Every field: arrays the same bits (both computed in float64, then
    cast to float32), scalars equal."""
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if w is None or isinstance(w, str):
            assert g == w, f.name
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w, f.name


@pytest.mark.parametrize("steps", [10, 50])
@pytest.mark.parametrize("name", SAMPLERS)
def test_plans_match_jax(name, steps):
    _assert_plans_equal(port_sched.make_plan(PORT_SCHEDULE, name, steps),
                        jax_sched.make_plan(JAX_SCHEDULE, name, steps))


@pytest.mark.parametrize("strength", [0.3, 0.8])
@pytest.mark.parametrize("name", SAMPLERS)
def test_plan_tail_matches_jax(name, strength):
    _assert_plans_equal(
        port_sched.plan_tail(port_sched.make_plan(PORT_SCHEDULE, name, 20),
                             strength),
        jax_sched.plan_tail(jax_sched.make_plan(JAX_SCHEDULE, name, 20),
                            strength))


def test_make_plan_rejects_unknown_sampler():
    with pytest.raises(ValueError, match="unknown sampler"):
        port_sched.make_plan(PORT_SCHEDULE, "lms", 10)


# ---------------------------------------------------------------- denoise

B, H, W, C, L, D = 2, 4, 4, 4, 3, 8
STEPS, MERGE, GUIDANCE = 6, 2, 5.0


def _inputs():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(B, H, W, C), f(B, L, D), f(B, L, D), f(B, L, D)


def _torch_unet(x, t, context, added=None, i=None):
    """A cheap deterministic stand-in: eps depends on x, t and context."""
    return torch.tanh(0.3 * x + 1e-4 * t[:, None, None, None]
                      + context.mean(dim=(1, 2))[:, None, None, None])


def _jax_unet(x, t, context, added, i):
    return jnp.tanh(0.3 * x + 1e-4 * t[:, None, None, None]
                    + context.mean(axis=(1, 2))[:, None, None, None])


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("name", SAMPLERS)
def test_denoise_matches_jax(name):
    """fp32, relative L2 <= 1e-5 (both loops in fp32, elementwise ops in
    another order only). DDPM: the port gets JAX's per-step draws,
    jax.random.split(rng, T) then jax.random.normal per step."""
    lat, text, aug, null = _inputs()
    rng = jax.random.PRNGKey(3)
    jplan = jax_sched.make_plan(JAX_SCHEDULE, name, STEPS)
    want = jax.jit(lambda x, tc, ac, nc: jax_denoise(
        _jax_unet, x, JaxBranch(context=tc, null=nc),
        JaxBranch(context=ac, null=nc), jplan, jnp.float32(GUIDANCE),
        jnp.int32(MERGE), rng=rng))(lat, text, aug, null)
    noise = None
    if name == "ddpm":
        noise = torch.from_numpy(np.stack([
            np.asarray(jax.random.normal(k, lat.shape, jnp.float32))
            for k in jax.random.split(rng, jplan.num_steps)]))
    t = torch.from_numpy
    got = denoise(_torch_unet, t(lat), CondBranch(t(text), t(null)),
                  CondBranch(t(aug), t(null)),
                  port_sched.make_plan(PORT_SCHEDULE, name, STEPS),
                  GUIDANCE, MERGE, noise=noise)
    assert _rel_l2(got.numpy(), np.asarray(want)) <= 1e-5


def test_ancestral_denoise_needs_noise():
    lat, text, aug, null = (torch.from_numpy(a) for a in _inputs())
    plan = port_sched.make_plan(PORT_SCHEDULE, "ddpm", 3)
    with pytest.raises(ValueError, match="generator or noise"):
        denoise(_torch_unet, lat, CondBranch(text, null),
                CondBranch(aug, null), plan, GUIDANCE, MERGE)
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    a, b = (denoise(_torch_unet, lat, CondBranch(text, null),
                    CondBranch(aug, null), plan, GUIDANCE, MERGE,
                    generator=gen()) for _ in range(2))
    assert torch.equal(a, b)


# ----------------------------------------------------------- generate_batch

PROMPTS = ["a photo of a man with a nose and blue eyes",
           "portrait of a woman, face, eyes, lips, in a garden"]


def _faces():
    rng = np.random.RandomState(1)
    faces, labels = [], []
    for i in range(2):
        faces.append(rng.randint(0, 255, (64, 64, 3), np.uint8))
        lab = np.zeros((64, 64), np.uint8)
        lab[8 + i:44, 10:50] = 1
        lab[15:20, 15:25] = 4
        lab[26:31, 28:34] = 10
        lab[34:38, 24:38] = 12 + i
        labels.append(lab)
    embeds = [rng.randn(1, 16).astype(np.float32) for _ in range(2)]
    return faces, labels, embeds


@pytest.fixture(scope="module")
def pipes():
    jbundle = jax_tiny_bundle()
    shapes = jax.eval_shape(jbundle.init_params, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        lambda x: np.zeros(x.shape, x.dtype), shapes)
    jpipe = JaxPipeline(jbundle, params, jax_tokenizer())
    config = PipelineConfig(height=32, width=32, num_inference_steps=3,
                            start_merge_step=1, scheduler="euler")
    ppipe = ConsistentIDPipeline(tiny_bundle(device="cpu", seed=2),
                                 synthetic_clip_tokenizer(),
                                 pipeline_config=config)
    return jpipe, ppipe


def test_generate_batch_stacks_conditioning_like_jax(pipes):
    """The port's stacked host conditioning against JAX generate_batch's
    (each request's prepare_conditioning, concatenated on axis 0): ids,
    indices, masks, embeddings and CLIP pixels exact (as
    tests/test_torch_pipeline.py)."""
    jpipe, ppipe = pipes
    faces, labels, embeds = _faces()
    got = ppipe.prepare_batch(PROMPTS, faces, None, labels, embeds)
    jconds = [jpipe.prepare_conditioning(
        p, Image.fromarray(f), parsing_labels=lab, faceid_embeds=e)
        for p, f, lab, e in zip(PROMPTS, faces, labels, embeds)]
    want = {k: np.concatenate([c[k] for c in jconds]) for k in jconds[0]}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("scheduler", ["euler", "dpmpp_2m"])
def test_generate_batch_request_equals_its_solo_run(pipes, scheduler):
    """Per-request seeds under ODE samplers: request i of a batch against
    the same request alone, decoded fp32 images within 1e-5 (CPU matmuls of
    another batch size may block differently)."""
    _, ppipe = pipes
    faces, labels, embeds = _faces()
    batch = ppipe.generate_batch(
        PROMPTS, faces, seeds=[11, 12], parsing_labels_list=labels,
        faceid_embeds_list=embeds, scheduler=scheduler, return_float=True)
    for i in range(2):
        solo = ppipe.generate_batch(
            PROMPTS[i:i + 1], faces[i:i + 1], seeds=[11 + i],
            parsing_labels_list=labels[i:i + 1],
            faceid_embeds_list=embeds[i:i + 1], scheduler=scheduler,
            return_float=True)
        torch.testing.assert_close(batch[i:i + 1], solo, rtol=0, atol=1e-5)
    assert not torch.equal(batch[0], batch[1])


def test_generate_batch_ddpm_is_seeded(pipes):
    """DDPM draws the batch's noise from request 0's generator (JAX keys it
    off seeds[0]): the same seeds give the same bits, other seeds other
    images."""
    _, ppipe = pipes
    faces, labels, embeds = _faces()

    def run(seeds):
        return ppipe.generate_batch(
            PROMPTS, faces, seeds=seeds, parsing_labels_list=labels,
            faceid_embeds_list=embeds, scheduler="ddpm", return_float=True)

    first = run([11, 12])
    assert torch.equal(first, run([11, 12]))
    assert not torch.equal(first[1], run([13, 12])[1])


def test_generate_async_matches_generate(pipes):
    """The async variants' images (uint8, through the callable) are the
    synchronous ones."""
    _, ppipe = pipes
    faces, labels, embeds = _faces()
    kw = dict(parsing_labels_list=labels, faceid_embeds_list=embeds,
              seeds=[3, 4])
    want = ppipe.generate_batch(PROMPTS, faces, **kw)
    got = ppipe.generate_batch_async(PROMPTS, faces, **kw)()
    np.testing.assert_array_equal(got, want)
    one = ppipe.generate_async(PROMPTS[0], faces[0], seed=3,
                               parsing_labels=labels[0],
                               faceid_embeds=embeds[0])()
    assert one.shape == (1, 32, 32, 3) and one.dtype == np.uint8
    np.testing.assert_array_equal(
        one, ppipe.generate(PROMPTS[0], faces[0], seed=3,
                            parsing_labels=labels[0],
                            faceid_embeds=embeds[0]))
