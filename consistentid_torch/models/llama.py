"""Llama decoder with a preallocated KV cache and greedy decoding: the
language half of the LLaVA-1.5 captioner, counterpart of the JAX package's
models/llama.py.

Numerics follow the JAX module (and HF `LlamaForCausalLM`): RMSNorm in
fp32, rotate-half RoPE with cos/sin from `theta^{-2i/d}` in fp32 cast to
the activations' dtype, grouped-query attention by repeating the KV heads,
attention logits as a product with an fp32 result (fp32 copies of q and
k: a bf16 product would round them to bf16 first) times d**-0.5, a causal
mask over absolute positions with -1e30 (built once a forward, and left
out where nothing is masked), an fp32 softmax, a SiLU-gated MLP, no
biases. The JAX attention is plain jnp (no Pallas kernel), so plain
torch stands here too.

The cache is a list of per-layer `LayerKV` (or, with `kv_quant`,
`QuantLayerKV`: int8 keys and values with one fp32 scale per (batch, head,
position), the scales folded into the logits and the probabilities, the
cache never dequantized) written in place at [cache_index, cache_index +
S). `quant=True` serves every projection (q/k/v/o, gate/up/down, lm_head)
as the port's W8A8 `Int8Dense` (ops/quant.py); `quantize_llama_params`
makes its state dict from a float one. The embedding table stays float.

`greedy_generate` prefills a cache of prompt_len + max_new_tokens, then
runs single-token steps in a Python loop that stops once every row has
emitted EOS (one `done.all()` read a step), as JAX's `lax.while_loop`;
each step attends over the whole cache with the unwritten slots masked,
as JAX's does, so its shapes are fixed and a card replays it from one
CUDA graph.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import LlamaConfig
from ..ops.quant import int_mm, quantize_state_like, quantize_symmetric
from .layers import linear


class LayerKV(NamedTuple):
    k: torch.Tensor  # (B, kv_heads, max_len, head_dim)
    v: torch.Tensor


class QuantLayerKV(NamedTuple):
    """int8 KV cache: per-(batch, head, position) symmetric scales."""

    k: torch.Tensor        # (B, kv_heads, max_len, head_dim) int8
    k_scale: torch.Tensor  # (B, kv_heads, max_len, 1) fp32
    v: torch.Tensor
    v_scale: torch.Tensor


Cache = List[Union[LayerKV, QuantLayerKV]]


def init_cache(config: LlamaConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.float32, kv_quant: bool = False,
               device=None, kv_heads: Optional[int] = None) -> Cache:
    """`kv_heads`: the KV heads this rank holds (a tensor-parallel rank's
    share; all of the config's by default)."""
    shape = (batch, kv_heads or config.num_kv_heads, max_len,
             config.head_dim)
    if kv_quant:
        sshape = shape[:-1] + (1,)
        return [QuantLayerKV(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.ones(sshape, dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.ones(sshape, dtype=torch.float32, device=device))
            for _ in range(config.num_layers)]
    return [LayerKV(torch.zeros(shape, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(config.num_layers)]


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF convention: freqs = pos * theta^{-2i/d}; emb = concat(freqs,
    freqs). positions (S,) -> cos/sin (S, head_dim) fp32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    freqs = positions.float()[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, H, S, D); cos/sin (S, D), cast to x's dtype first (a no-op
    when the caller cast them once for all layers)."""
    cos = cos[None, None].to(x.dtype)
    sin = sin[None, None].to(x.dtype)
    return x * cos + _rotate_half(x) * sin


def causal_mask(cache_index, s: int, attn_len: int,
                device) -> Optional[torch.Tensor]:
    """(S, attn_len) bool, True where key position k > query position
    cache_index + i (masked). `cache_index` is an int or a (1,) tensor on
    the device; None when it is an int and no key is masked."""
    if isinstance(cache_index, int) and attn_len <= cache_index + 1:
        return None
    q_pos = (cache_index + torch.arange(s, device=device))[:, None]
    k_pos = torch.arange(attn_len, device=device)[None, :]
    return k_pos > q_pos


class RMSNorm(nn.Module):
    """Normalised in fp32, cast to the weight's dtype, then scaled."""

    def __init__(self, hidden_size: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = F.rms_norm(x.float(), (x.shape[-1],), eps=self.eps)
        return self.weight * xf.to(self.weight.dtype)


def _proj(in_features: int, out_features: int, quant: bool) -> nn.Module:
    return linear(in_features, out_features, bias=False, quant=quant)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, quant: bool = False):
        super().__init__()
        self.config = cfg = config
        d = cfg.head_dim
        # the heads this module runs (a tensor-parallel rank's share)
        self.num_heads, self.num_kv_heads = cfg.num_heads, cfg.num_kv_heads
        self.q_proj = _proj(cfg.hidden_size, cfg.num_heads * d, quant)
        self.k_proj = _proj(cfg.hidden_size, cfg.num_kv_heads * d, quant)
        self.v_proj = _proj(cfg.hidden_size, cfg.num_kv_heads * d, quant)
        self.o_proj = _proj(cfg.num_heads * d, cfg.hidden_size, quant)

    def forward(self, x, cos, sin, kv, positions: torch.Tensor,
                attn_len: int, mask: Optional[torch.Tensor] = None):
        """x (B, S, E); the new keys and values are written into `kv` at
        `positions` (S,); the first `attn_len` slots are attended, but
        where `mask` (`causal_mask`) is True. Returns (out, kv)."""
        b, s, _ = x.shape
        d = self.config.head_dim
        heads, kv_heads = self.num_heads, self.num_kv_heads
        q = self.q_proj(x).view(b, s, heads, d).transpose(1, 2)
        k = self.k_proj(x).view(b, s, kv_heads, d).transpose(1, 2)
        v = self.v_proj(x).view(b, s, kv_heads, d).transpose(1, 2)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        k_scale = v_scale = None
        if isinstance(kv, QuantLayerKV):
            kq, ks = quantize_symmetric(k, (3,), keepdim=True)
            vq, vs = quantize_symmetric(v, (3,), keepdim=True)
            for buf, new in zip(kv, (kq, ks, vq, vs)):
                buf.index_copy_(2, positions, new)
            # (B, kv_heads, 1, attn_len), broadcast over query positions
            k_scale = kv.k_scale[:, :, :attn_len, 0][:, :, None, :]
            v_scale = kv.v_scale[:, :, :attn_len, 0][:, :, None, :]
        else:
            kv.k.index_copy_(2, positions, k.to(kv.k.dtype))
            kv.v.index_copy_(2, positions, v.to(kv.v.dtype))
        kk = kv.k[:, :, :attn_len]
        vv = kv.v[:, :, :attn_len]
        rep = heads // kv_heads
        if rep > 1:
            kk = kk.repeat_interleave(rep, dim=1)
            vv = vv.repeat_interleave(rep, dim=1)
            if k_scale is not None:
                k_scale = k_scale.repeat_interleave(rep, dim=1)
                v_scale = v_scale.repeat_interleave(rep, dim=1)

        # JAX: einsum of q and k in q's dtype with an fp32 result
        logits = torch.matmul(q.float(), kk.float().transpose(-1, -2)) \
            * (d ** -0.5)
        if k_scale is not None:
            logits = logits * k_scale
        if mask is not None:
            logits = logits.masked_fill(mask, -1e30)
        probs = torch.softmax(logits, dim=-1)
        if v_scale is not None:
            probs = probs * v_scale
        out = torch.matmul(probs.to(q.dtype), vv.to(q.dtype)).to(x.dtype)
        out = out.transpose(1, 2).reshape(b, s, heads * d)
        return self.o_proj(out), kv


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, quant: bool = False):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = _proj(h, i, quant)
        self.up_proj = _proj(h, i, quant)
        self.down_proj = _proj(i, h, quant)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, quant: bool = False):
        super().__init__()
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps)
        self.self_attn = LlamaAttention(config, quant)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps)
        self.mlp = LlamaMLP(config, quant)

    def forward(self, x, cos, sin, kv, positions, attn_len, mask=None):
        attn, kv = self.self_attn(self.input_layernorm(x), cos, sin, kv,
                                  positions, attn_len, mask)
        x = x + attn
        return x + self.mlp(self.post_attention_layernorm(x)), kv


class LlamaForCausalLM(nn.Module):
    """Causal LM over token ids or precomputed input embeddings (the LLaVA
    splice). Returns (logits, cache). Submodules carry the JAX tree's names
    (embed_tokens, layers_{i}, norm, lm_head)."""

    def __init__(self, config: LlamaConfig, quant: bool = False,
                 kv_quant: bool = False):
        super().__init__()
        self.config = cfg = config
        self.quant = quant
        self.kv_quant = kv_quant
        # a tensor-parallel rank's KV heads (its cache), and whether its
        # decode must run eagerly (parallel/tensor_parallel.py)
        self.kv_heads = cfg.num_kv_heads
        self.eager_decode = False
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        for i in range(cfg.num_layers):
            self.add_module(f"layers_{i}", LlamaDecoderLayer(cfg, quant))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        if not cfg.tie_word_embeddings:
            self.lm_head = _proj(cfg.hidden_size, cfg.vocab_size, quant)
        for name, mod in self.named_modules():
            if hasattr(mod, "path"):        # the int8 layers' error names
                mod.path = name

    @property
    def dtype(self) -> torch.dtype:
        return self.embed_tokens.weight.dtype

    def forward(self, input_ids: Optional[torch.Tensor] = None,
                cache: Optional[Cache] = None, cache_index=0,
                attn_len: Optional[int] = None,
                inputs_embeds: Optional[torch.Tensor] = None):
        """`cache_index`: the first new position, an int or a (1,) long
        tensor on the device (the captured decode step's)."""
        cfg = self.config
        if inputs_embeds is None:
            inputs_embeds = self.embed_tokens(input_ids)
        b, s, _ = inputs_embeds.shape
        if cache is None:
            cache = init_cache(cfg, b, s, dtype=self.dtype,
                               device=inputs_embeds.device,
                               kv_heads=self.kv_heads)
            attn_len = s
        if attn_len is None:
            attn_len = cache[0].k.shape[2]
        device = inputs_embeds.device
        positions = cache_index + torch.arange(s, device=device)
        cos, sin = (t.to(inputs_embeds.dtype) for t in rope_cos_sin(
            positions, cfg.head_dim, cfg.rope_theta))
        mask = causal_mask(cache_index, s, attn_len, device)
        x = inputs_embeds
        new_cache = []
        for i, kv in enumerate(cache):
            x, kv = getattr(self, f"layers_{i}")(x, cos, sin, kv,
                                                 positions, attn_len, mask)
            new_cache.append(kv)
        x = self.norm(x)
        if cfg.tie_word_embeddings:
            logits = F.linear(x, self.embed_tokens.weight)
        else:
            logits = self.lm_head(x)
        return logits, new_cache


def _capture(step: Callable[[], None]) -> Callable[[], None]:
    """Run `step` once on a side stream (a real step, which sets up
    cuBLAS and the allocator for it), then record it into a CUDA graph:
    returns the replay. `int_mm.launches` counts the graph's `_int_mm`
    calls at each replay, where they launch, not at the recording."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = int_mm.launches
    with torch.cuda.graph(graph):
        step()
    per_replay, int_mm.launches = int_mm.launches - before, before

    def replay():
        graph.replay()
        int_mm.launches += per_replay
    return replay


@torch.no_grad()
def greedy_generate(model: LlamaForCausalLM,
                    prompt: Optional[torch.Tensor], max_new_tokens: int,
                    eos_token_id: int, pad_token_id: int = 0,
                    prompt_embeds: Optional[torch.Tensor] = None,
                    kv_quant: Optional[bool] = None) -> torch.Tensor:
    """Greedy decode (the reference captions with temperature=0,
    data/FGID_caption.py:57). Returns (B, max_new_tokens) int64, padded
    with pad_token_id after EOS; EOS itself is kept. `kv_quant` (default
    the model's flag) selects the int8 cache.

    The prefill runs eagerly. A decode step feeds the last token at a
    position held in a (1,) tensor and attends over the whole cache, the
    slots not yet written masked, as JAX's: its shapes never change, so
    on a card the first step runs eagerly and the rest replay one CUDA
    graph of it (all run eagerly where `model.eager_decode` is set: a
    tensor-parallel decoder over gloo, whose collectives a graph cannot
    hold). `greedy_generate.events`, when a list, gets the CUDA
    events around each call's prefill and decode (card only)."""
    cfg = model.config
    src = prompt_embeds if prompt_embeds is not None else prompt
    b, prompt_len = src.shape[:2]
    device = src.device
    timed = greedy_generate.events is not None and device.type == "cuda"
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)] \
        if timed else []
    if timed:
        marks[0].record()
    max_len = prompt_len + max_new_tokens
    cache = init_cache(cfg, b, max_len, dtype=model.dtype,
                       kv_quant=model.kv_quant if kv_quant is None
                       else kv_quant, device=device, kv_heads=model.kv_heads)
    logits, cache = model(prompt if prompt_embeds is None else None,
                          cache=cache, cache_index=0, attn_len=prompt_len,
                          inputs_embeds=prompt_embeds)
    tok = logits[:, -1].argmax(dim=-1)
    pos = torch.full((1,), prompt_len, dtype=torch.long, device=device)
    if timed:
        marks[1].record()

    def advance():
        logits, _ = model(tok[:, None], cache=cache, cache_index=pos,
                          attn_len=max_len)
        tok.copy_(logits[:, -1].argmax(dim=-1))
        pos.add_(1)

    step = advance if device.type != "cuda" or model.eager_decode else None
    out = torch.full((b, max_new_tokens), pad_token_id, dtype=torch.long,
                     device=device)
    done = torch.zeros(b, dtype=torch.bool, device=device)
    steps = 0
    for i in range(max_new_tokens):
        out[:, i] = torch.where(done, pad_token_id, tok)
        done |= tok == eos_token_id
        if i + 1 == max_new_tokens or bool(done.all()):
            break
        if step is None:
            step = _capture(advance)
        else:
            step()
        steps += 1
    if timed:
        marks[2].record()
        greedy_generate.events.append(dict(prefill=marks[:2],
                                           decode=marks[1:], steps=steps))
    return out


greedy_generate.events = None


def quantize_llama_params(config: LlamaConfig, state) -> dict:
    """A float Llama state dict -> the one `LlamaForCausalLM(quant=True)`
    loads: every projection's weight becomes kernel_q (int8, per output
    channel) + kernel_scale (fp32), on the weight's device; the norms and
    the embedding table pass through."""
    with torch.device("meta"):
        target = LlamaForCausalLM(config, quant=True).state_dict()
    return quantize_state_like(target, state)
