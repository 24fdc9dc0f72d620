"""Facial captioner interface, the in-repo LLaVA-1.5 captioner and the
external-VLM adapters: the port's counterpart of the JAX package's
conditioning/captioner.py.

The reference optionally drives LLaVA-1.5 for facial captions
(models/LLaVA, data/FGID_caption.py:36-116) but ships with it disabled: at
inference a fixed template is used instead
(pipline_StableDiffusion_ConsistentID.py:265-286). A captioner is any
callable image -> (caption, facial_detail_caption).

`LlavaCaptioner` runs models/llava.py on the card (bf16; `quant="int8"`
serves the decoder's projections in W8A8, `kv_quant` an int8 KV cache);
`TemplateCaptioner` is the default; `VLMCaptioner` adapts an in-process
model with `generate(image, prompt) -> str`; `SubprocessCaptioner` and
`HTTPCaptioner` adapt an external VLM through the JAX package's protocols
(one JSON object per line on stdin/stdout, or a POST), the same keys and
values, numpy images sent as PNG (utils/png.encode_png).

An image is a uint8 (H, W[, C]) array or a path. `LlavaCaptioner` reads a
path itself with utils/png.read_image, so a JPEG path is refused (no JPEG
decoder on the card's machine); the external adapters send the path on.
With a mesh (`tp > 1` in `make_captioner`) the decoder is split over the
mesh's model group (parallel/tensor_parallel.py): each rank reads 1/tp of
the weights per token, and every rank returns the same captions.
"""
from __future__ import annotations

import base64
import json
import subprocess
from typing import Callable, Optional, Protocol, Tuple

import numpy as np

FACE_CAPTION_TEMPLATE = (
    "The person has one face, one nose, two eyes, two ears, and one mouth.")
# reference FGID prompts, whitespace quirk from the \-continuation included
# (data/FGID_caption.py:21-24)
CAPTION_PROMPT = ("Please describe the people in the image, including their "
                  "gender,         age, clothing, facial expressions, and "
                  "any other distinguishing features.")
DETAIL_PROMPT = ("Describe this person's facial features for me, including "
                 "        face, ears, eyes, nose, and mouth.")
class Captioner(Protocol):
    def __call__(self, image) -> Tuple[str, str]: ...


# llava_v1 conversation template (what the reference's vendored LLaVA
# code resolves to for llava-v1.5 with conv_mode=None,
# models/LLaVA/demo_llva_use.py:28): "{system} USER: <image>\n{query}
# ASSISTANT:" with sep=" " after the user turn.
LLAVA_SYSTEM = (
    "A chat between a curious human and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite answers "
    "to the human's questions.")


def llava_v1_prompt_parts(query: str,
                          system: str = LLAVA_SYSTEM) -> Tuple[str, str]:
    """Text before/after the `<image>` slot in the llava_v1 prompt: the
    image features replace `<image>` in `{system} USER: <image>\\n{query}
    ASSISTANT:`."""
    return f"{system} USER: ", f"\n{query} ASSISTANT:"


def load_llava(model_dir: str, config=None, device="cuda", dtype=None):
    """An HF llava-1.5 checkpoint directory (safetensors shards, modern or
    legacy key layout) -> a float `models.llava.Llava` on `device` in
    `dtype` (default bf16). Built on the meta device, then each tensor
    copied in shard by shard in its file dtype: no fp32 host copy."""
    import torch

    from ..core.config import LlavaConfig
    from ..core.dtypes import resolve_device
    from ..io.convert_backbones import llava_names_from_hf
    from ..io.safetensors_reader import (checkpoint_files,
                                         iter_safetensors_torch,
                                         read_safetensors_header)
    from ..models.llava import Llava

    cfg = config or LlavaConfig()
    device = resolve_device(device)
    files = checkpoint_files(model_dir)
    keys = [k for path in files for k in read_safetensors_header(path)[0]]
    hf_to_port = {hf: port for port, hf in
                  llava_names_from_hf(keys, cfg).items()}
    with torch.device("meta"):
        model = Llava(cfg)
    model = model.to_empty(device=device).to(dtype or torch.bfloat16)
    state = model.state_dict()
    filled = set()
    with torch.no_grad():
        for path in files:
            for key, t in iter_safetensors_torch(path):
                name = hf_to_port.get(key)
                if name is None:
                    continue
                state[name].copy_(t.reshape(state[name].shape))
                filled.add(name)
    missing = sorted(set(state) - filled)
    if missing:
        raise KeyError(f"{model_dir}: no tensor for {missing[:5]} "
                       f"({len(missing)} missing)")
    return model.eval()


class LlavaCaptioner:
    """Runs the in-repo LLaVA-1.5 (models/llava.py): the runnable
    equivalent of the reference's torch LLaVA captioning script
    (data/FGID_caption.py:20-78).

    `model` is a `models.llava.Llava` (float, or with an int8 decoder).
    With `quant="int8"` a float decoder is quantized once into a new int8
    decoder that shares nothing with `model`'s (the caller's model is left
    as it is); `kv_quant` uses the int8 KV cache. `tokenizer` is any HF-style
    Llama tokenizer (`encode` prepending BOS, `decode(ids,
    skip_special_tokens=True)`, `bos_token_id`, `eos_token_id`; the port's
    conditioning/llama_tokenizer.py). Prompt ids follow upstream
    `tokenizer_image_token`: [bos] + pre + <features> + post without its
    bos; greedy decode is the reference's temperature=0. The model runs
    in its own dtype (bf16 from `from_pretrained`). With a `mesh` of a
    model axis above 1 the decoder (after any int8 conversion) is split
    over it, Megatron-style, into a new decoder; the vision tower and the
    projector stay whole (JAX :91-120)."""

    def __init__(self, model, tokenizer, config=None,
                 max_new_tokens: int = 512,
                 caption_prompt: str = CAPTION_PROMPT,
                 detail_prompt: str = DETAIL_PROMPT,
                 system: str = LLAVA_SYSTEM, quant: str = "none",
                 kv_quant: bool = False, mesh=None):
        from ..models.llama import LlamaForCausalLM, quantize_llama_params
        from ..models.llava import Llava, make_caption_fn
        from ..parallel.mesh import model_axis_size
        from ..parallel.tensor_parallel import (apply_llama_tensor_parallel,
                                                shared_copy)

        self.config = config or model.config
        if quant == "int8" and not model.llama.quant:
            import torch
            with torch.device("meta"):
                llama = LlamaForCausalLM(self.config.text, quant=True)
            llama.load_state_dict(quantize_llama_params(
                self.config.text, model.llama.state_dict()), assign=True)
            model = Llava(self.config, mm=model.mm, llama=llama.eval())
        elif quant not in ("none", "int8"):
            raise ValueError(f"unknown quant mode {quant!r} "
                             "(expected 'none' or 'int8')")
        if model_axis_size(mesh) > 1:
            model = Llava(self.config, mm=model.mm,
                          llama=apply_llama_tensor_parallel(
                              shared_copy(model.llama), mesh))
        self.mesh = mesh
        self.model = model
        self.kv_quant = kv_quant
        self.tokenizer = tokenizer
        self.caption_prompt = caption_prompt
        self.detail_prompt = detail_prompt
        self.system = system
        self._fn = make_caption_fn(
            model, max_new_tokens=max_new_tokens,
            eos_token_id=int(tokenizer.eos_token_id), pad_token_id=0,
            kv_quant=kv_quant)

    @classmethod
    def from_pretrained(cls, model_dir: str, device="cuda", dtype=None,
                        **kw) -> "LlavaCaptioner":
        """An HF llava-1.5 checkpoint directory (safetensors shards and
        tokenizer.json) on `device` (`load_llava`)."""
        from .llama_tokenizer import LlamaTokenizer

        cfg = kw.pop("config", None)
        model = load_llava(model_dir, cfg, device=device, dtype=dtype)
        tok = LlamaTokenizer.from_pretrained(model_dir)
        return cls(model, tok, config=model.config, **kw)

    def _encode_parts(self, query: str):
        pre_text, post_text = llava_v1_prompt_parts(query, self.system)
        pre = list(self.tokenizer.encode(pre_text))
        post = list(self.tokenizer.encode(post_text))
        # upstream tokenizer_image_token: the post chunk's BOS is dropped
        bos = getattr(self.tokenizer, "bos_token_id", None)
        if bos is not None and post and post[0] == bos:
            post = post[1:]
        return np.asarray(pre, np.int64), np.asarray(post, np.int64)

    def _decode_row(self, toks) -> str:
        # pads (0) only ever appear after EOS, so cutting at EOS is enough
        eos = int(self.tokenizer.eos_token_id)
        ids = toks[:toks.index(eos)] if eos in toks else toks
        return self.tokenizer.decode(ids, skip_special_tokens=True).strip()

    def _pixels(self, image) -> np.ndarray:
        from ..models.llava import preprocess_image
        from ..utils.png import read_image

        if isinstance(image, str):
            image = read_image(image)
        return preprocess_image(image, self.config.vision.image_size)

    def generate_ids(self, images, prompt: str) -> np.ndarray:
        """(B, max_new_tokens) int64 ids for a batch of images under one
        prompt: one batched prefill and decode."""
        pre, post = self._encode_parts(prompt)
        pixels = np.concatenate([self._pixels(im) for im in images])
        return self._fn(pixels, pre, post).cpu().numpy()

    def generate(self, image, prompt: str) -> str:
        return self._decode_row(self.generate_ids([image], prompt)[0]
                                .tolist())

    def generate_batch(self, images, prompt: str) -> list:
        """One batched prefill + decode over the stacked images; the FGID
        prompt is shared by the batch (apps/fgid.py --batch)."""
        return [self._decode_row(row.tolist())
                for row in self.generate_ids(images, prompt)]

    def caption_batch(self, images) -> list:
        """[(caption, facial_detail_caption)] for a batch of images; two
        batched passes (one per FGID prompt)."""
        caps = self.generate_batch(images, self.caption_prompt)
        details = self.generate_batch(images, self.detail_prompt)
        return list(zip(caps, details))

    def __call__(self, image) -> Tuple[str, str]:
        return (self.generate(image, self.caption_prompt),
                self.generate(image, self.detail_prompt))


class TemplateCaptioner:
    """Fixed-template captions (the reference's shipped behavior)."""

    def __init__(self, caption: str = "a photo of a person.",
                 detail: str = FACE_CAPTION_TEMPLATE):
        self.caption = caption
        self.detail = detail

    def __call__(self, image) -> Tuple[str, str]:
        return self.caption, self.detail


class VLMCaptioner:
    """Adapter over a local VLM with generate(image, prompt) -> str."""

    def __init__(self, vlm, caption_prompt: str = CAPTION_PROMPT,
                 detail_prompt: str = DETAIL_PROMPT):
        self.vlm = vlm
        self.caption_prompt = caption_prompt
        self.detail_prompt = detail_prompt

    def __call__(self, image) -> Tuple[str, str]:
        return (self.vlm.generate(image, self.caption_prompt),
                self.vlm.generate(image, self.detail_prompt))


def _image_payload(image) -> dict:
    """str path -> {"image_path": ...}; a uint8 image -> {"image_b64": its
    PNG, base64}."""
    from ..utils.png import encode_png

    if isinstance(image, str):
        return {"image_path": image}
    png = encode_png(np.asarray(image, np.uint8))
    return {"image_b64": base64.b64encode(png).decode()}


class SubprocessCaptioner:
    """External-process VLM over a persistent worker.

    Protocol: one JSON object per line on stdin
        {"prompt": str, "image_path": str} or {..., "image_b64": str}
    one JSON object per line on stdout
        {"text": str}   (or {"error": str} -> RuntimeError)

    The worker is spawned once and reused for the whole dataset. Use as a
    context manager or call close() to end the worker."""

    def __init__(self, command, caption_prompt: str = CAPTION_PROMPT,
                 detail_prompt: str = DETAIL_PROMPT):
        if isinstance(command, str):
            import shlex
            command = shlex.split(command)
        self._proc = subprocess.Popen(
            command, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, bufsize=1)
        self.caption_prompt = caption_prompt
        self.detail_prompt = detail_prompt

    def _ask(self, image, prompt: str) -> str:
        req = {"prompt": prompt, **_image_payload(image)}
        self._proc.stdin.write(json.dumps(req) + "\n")
        self._proc.stdin.flush()
        line = self._proc.stdout.readline()
        if not line:
            rc = self._proc.poll()
            raise RuntimeError(f"captioner worker died (exit {rc})")
        out = json.loads(line)
        if "error" in out:
            raise RuntimeError(f"captioner error: {out['error']}")
        return out["text"]

    def __call__(self, image) -> Tuple[str, str]:
        return (self._ask(image, self.caption_prompt),
                self._ask(image, self.detail_prompt))

    def close(self):
        if self._proc.poll() is None:
            self._proc.stdin.close()
            self._proc.wait(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class HTTPCaptioner:
    """External VLM behind an HTTP endpoint: POST {url} with JSON
    {"prompt": str, "image_b64"/"image_path": str}, response JSON
    {"text": str}."""

    def __init__(self, url: str, caption_prompt: str = CAPTION_PROMPT,
                 detail_prompt: str = DETAIL_PROMPT,
                 timeout: float = 120.0):
        self.url = url
        self.caption_prompt = caption_prompt
        self.detail_prompt = detail_prompt
        self.timeout = timeout

    def _ask(self, image, prompt: str) -> str:
        import urllib.request

        req = urllib.request.Request(
            self.url,
            data=json.dumps({"prompt": prompt,
                             **_image_payload(image)}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read())["text"]

    def __call__(self, image) -> Tuple[str, str]:
        return (self._ask(image, self.caption_prompt),
                self._ask(image, self.detail_prompt))


def make_captioner(command: Optional[str] = None,
                   url: Optional[str] = None,
                   llava_dir: Optional[str] = None,
                   quant: str = "none", tp: int = 1,
                   kv_quant: bool = False, device="cuda") -> Callable:
    """CLI helper: the captioner of the --captioner-llava / --captioner-cmd
    / --captioner-url flags, the template when none is given.
    `quant`/`tp`/`kv_quant`/`device` apply to the in-repo LLaVA only;
    `tp > 1` splits its decoder over a (1, tp) mesh of the process group,
    which must then have tp ranks (apps.fgid starts them)."""
    if llava_dir:
        mesh = None
        if tp > 1:
            import torch

            from ..parallel import initialize_multihost, make_mesh, world_size
            device_type = torch.device(device).type
            initialize_multihost(device_type=device_type)
            if world_size() != tp:
                raise ValueError(f"--tp {tp} runs on {tp} ranks; this "
                                 f"process group has {world_size()} (start "
                                 f"it under torchrun --nproc-per-node {tp})")
            mesh = make_mesh(data=1, model=tp, device_type=device_type)
            device = mesh.device
        return LlavaCaptioner.from_pretrained(
            llava_dir, device=device, quant=quant, kv_quant=kv_quant,
            mesh=mesh)
    if command:
        return SubprocessCaptioner(command)
    if url:
        return HTTPCaptioner(url)
    return TemplateCaptioner()
