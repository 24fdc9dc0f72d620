"""The port's calibrate_int8 through the SDXL pipeline (its dual-tower
contexts, pooled embeddings and time_ids) against the JAX package's on the
CPU, fp32. The SDXL int8 UNet itself is held in tests/test_torch_quant.py.

Tolerances and the shared activation codes are those of
tests/test_torch_quant.py (its module docstring): with JAX's codes shared,
the UNet output within 1e-5 relative L2 and the calibrated scale tree within
rtol 1e-5. The port's calibration contexts and added conditioning are held
to JAX's before JAX's replace them: the contexts and pooled embeddings within
1e-4 (fp32 towers, summation order only), time_ids exact.

The pipeline is the tiny SDXL set with the two-level SDXL UNet of
tests/test_torch_quant.py (text_time embedding, linear transformer
projections, a depth-2 transformer, a level without attention), LoRA and
the IP branch added.
"""
import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from consistentid_tpu.conditioning import CLIPBPETokenizer as JaxTokenizer
from consistentid_tpu.core import PipelineConfig as JaxPipelineConfig
from consistentid_tpu.core import UNetConfig as JaxUNetConfig
from consistentid_tpu.pipelines import ConsistentIDXLPipeline as JaxXLPipeline
from consistentid_tpu.testing import tiny_sdxl_bundle as jax_tiny_sdxl
from consistentid_torch.conditioning import CLIPBPETokenizer
from consistentid_torch.core import PipelineConfig, UNetConfig
from consistentid_torch.io import params_from_jax
from consistentid_torch.io.from_jax import tree_from_module
from consistentid_torch.pipelines import ConsistentIDXLPipeline, SDXLBundle
from consistentid_torch.testing import (synthetic_clip_tokenizer,
                                        tiny_sdxl_bundle)
from test_torch_loading import one_torch_thread  # noqa: F401
from test_torch_quant import (PROMPT, SIZE, SMALL_SDXL_UNET,
                              _assert_trees_equal, _draw, _face)
from test_torch_quant import tape  # noqa: F401

PIPE_UNET = dict(SMALL_SDXL_UNET, lora_rank=4, ip_num_tokens=4)
TOWERS = 1e-4


@pytest.fixture(scope="module")
def xl_pipes():
    """The JAX and the port SDXL pipelines on one set of parameters: the
    tiny SDXL set with the two-level UNet, LoRA and the IP branch. The
    tokenizers share a vocab with eos at CLIP's id 49407, where the towers
    read the pooled state; the second pads with "!"."""
    jbundle = dataclasses.replace(jax_tiny_sdxl(),
                                  unet_config=JaxUNetConfig(**PIPE_UNET))
    base = tiny_sdxl_bundle(device="cpu")
    pbundle = SDXLBundle(UNetConfig(**PIPE_UNET), base.adapter_config,
                         base.vae_config, base.text_config,
                         base.vision_config, text_config_2=base.text_config_2,
                         device="cpu")
    params = _draw(tree_from_module(pbundle)[0], 10)
    pbundle.load_state_dict(params_from_jax(params), strict=True)
    vocab = {**synthetic_clip_tokenizer().encoder, "<|endoftext|>": 49407}
    config = dict(height=SIZE, width=SIZE, num_inference_steps=2,
                  start_merge_step=1)
    jpipe = JaxXLPipeline(jbundle, params, JaxTokenizer(vocab, []),
                          tokenizer_2=JaxTokenizer(vocab, [], pad_token="!"),
                          pipeline_config=JaxPipelineConfig(**config))
    ppipe = ConsistentIDXLPipeline(
        pbundle, CLIPBPETokenizer(vocab, []),
        tokenizer_2=CLIPBPETokenizer(vocab, [], pad_token="!"),
        pipeline_config=PipelineConfig(**config))
    return jpipe, ppipe


def test_sdxl_calibrate_int8_matches_jax(xl_pipes, tape):
    """calibrate_int8 through the SDXL pipeline against JAX's (one step,
    LoRA folded at 0.8, the face resized from 72x80): the port's
    calibration batch is the facial null, facial and text-only contexts
    with their pooled embeddings and time_ids, held to JAX's (contexts and
    pooled 1e-4, time_ids exact), then replaced by JAX's; with JAX's noise
    and codes the scale tree at rtol 1e-5 over every quantized layer."""
    jpipe, ppipe = xl_pipes
    face, labels, faceid = _face()
    kw = dict(num_calib_steps=1, seed=5, margin=1.1, lora_scale=0.8,
              parsing_labels=labels, faceid_embeds=faceid)
    batches = []
    jax_batch = jpipe._calibration_batch

    def keep_batch(params, cond):
        out = jax_batch(params, cond)
        jax.debug.callback(lambda b: batches.append(jax.device_get(b)), out)
        return out

    tape.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe, "_calibration_batch", keep_batch)
        jstatic = jpipe.calibrate_int8(PROMPT, Image.fromarray(face), **kw)
    (want_ctx, want_added), = batches
    _, k = jax.random.split(jax.random.PRNGKey(5))   # JAX's one draw
    noise = [np.asarray(jax.random.normal(k, (1, SIZE // 2, SIZE // 2, 4)))]
    port_batch = ppipe._calibration_batch
    seen = []

    def jax_batches(cond):
        ctx, added = port_batch(cond)
        np.testing.assert_allclose(ctx.numpy(), want_ctx, rtol=0,
                                   atol=TOWERS)
        assert added.keys() == want_added.keys()
        np.testing.assert_allclose(added["text_embeds"].numpy(),
                                   want_added["text_embeds"], rtol=0,
                                   atol=TOWERS)
        np.testing.assert_array_equal(added["time_ids"].numpy(),
                                      want_added["time_ids"])
        seen.append(ctx.shape)
        return torch.tensor(want_ctx), {
            k: torch.tensor(v) for k, v in want_added.items()}

    with pytest.MonkeyPatch.context() as mp:
        tape.forcing(mp)
        mp.setattr(ppipe, "_calibration_batch", jax_batches)
        pstatic = ppipe.calibrate_int8(PROMPT, face, noise=noise, **kw)
    tape.check()
    assert seen == [want_ctx.shape] and want_ctx.shape[0] == 3
    np.testing.assert_array_equal(want_added["time_ids"],
                                  [[SIZE, SIZE, 0, 0, SIZE, SIZE]] * 3)
    assert isinstance(pstatic.bundle, SDXLBundle)
    assert pstatic.bundle.quant == "int8_static"
    _assert_trees_equal(pstatic.bundle.act_scales,
                        jax.device_get(jstatic.bundle.act_scales), rtol=1e-5)
