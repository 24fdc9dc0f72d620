"""The port's LLaVA-1.5 captioner (models/llama.py, models/llava.py,
conditioning/llama_tokenizer.py, conditioning/captioner.py, the HF
converters and the shard loader) against the JAX package's, on the CPU at
a tiny config: parameters drawn with numpy in the JAX modules' shapes
(`jax.eval_shape`) and carried across with `params_from_jax`; each JAX
reference jitted once and shared by the cases that run the same graph.
The tokenizer is held to the `tokenizers` library on a synthetic
Llama-2-style tokenizer.json, and the JAX captioner gets transformers'
fast tokenizer over that file (the CPU reference; the card's machine has
neither package).

Tolerances: fp32 logits and image features 1e-5 relative L2 (XLA's and
torch's CPU kernels sum in other orders); greedy ids, caption strings,
the PIL preprocessing, the int8 layout and the converted trees exactly;
int8 and int8-KV logits 1e-5 relative L2 with JAX's activation and KV
codes replayed into the port's quantizers (run freely, a last-bit
difference can flip a code at a .5 boundary), the port's own codes within
one of JAX's on at most 0.1% of them."""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from consistentid_tpu.conditioning import captioner as jax_captioner
from consistentid_tpu.core.config import CLIPVisionConfig as JaxVision
from consistentid_tpu.core.config import LlamaConfig as JaxLlama
from consistentid_tpu.core.config import LlavaConfig as JaxLlava
from consistentid_tpu.io import convert_backbones as jax_cb
from consistentid_tpu.models import layers as jax_layers
from consistentid_tpu.models import llama as jax_llama
from consistentid_tpu.models import llava as jax_llava
from consistentid_tpu.ops import quant as jax_quant
from consistentid_torch.apps import fgid
from consistentid_torch.conditioning import captioner
from consistentid_torch.conditioning.llama_tokenizer import LlamaTokenizer
from consistentid_torch.io import convert_backbones as cb
from consistentid_torch.io import params_from_jax
from consistentid_torch.io.export_backbones import llava_to_hf
from consistentid_torch.io.safetensors_reader import write_safetensors_torch
from consistentid_torch.models import layers as port_layers
from consistentid_torch.models import llama, llava
from consistentid_torch.testing import (TINY_LLAVA_TEXT, TINY_LLAVA_VISION,
                                        synthetic_llama_tokenizer_json,
                                        tiny_llava_config,
                                        write_llama_tokenizer)
from consistentid_torch.utils.png import encode_png
from test_torch_loading import one_torch_thread  # noqa: F401

VISION, TEXT = TINY_LLAVA_VISION, TINY_LLAVA_TEXT
VOCAB = TEXT["vocab_size"]
JCFG = JaxLlava(vision=JaxVision(**VISION), text=JaxLlama(**TEXT),
                image_token_id=VOCAB - 1)
CFG = tiny_llava_config()
PROMPT_LEN, NEW = 7, 10
NEVER = VOCAB + 7            # an EOS id greedy decoding never emits
CAPTION_TOKENS = 8
INT8_STEPS = 3               # decode steps of the int8 / KV-cache cases
REL = 1e-5
FLIP_SHARE = 1e-3


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _draw(shapes, seed):
    """Numpy draws in a flax tree's shapes: fan-in normal kernels,
    embeddings N(0, 1), RMSNorm weights and LayerNorm scales 1 + N(0,
    0.1^2), everything else N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def draw(key, x):
        if isinstance(x, dict):
            return {k: draw(k, v) for k, v in x.items()}
        z = rng.standard_normal(x.shape).astype(np.float32)
        if key == "kernel":
            return z / np.sqrt(np.prod(x.shape[:-1]))
        if key == "embedding":
            return z
        return 1.0 + 0.1 * z if key in ("scale", "weight") else 0.1 * z

    return draw(None, shapes)


@pytest.fixture(scope="module")
def params():
    shapes = jax.eval_shape(
        lambda: jax_llava.random_llava_params(jax.random.PRNGKey(0), JCFG))
    return _draw(jax.tree_util.tree_map(lambda s: s, shapes), 0)


@pytest.fixture(scope="module")
def model(params):
    m = llava.Llava(CFG)
    m.load_state_dict(params_from_jax(params), strict=True)
    return m.eval()


@pytest.fixture(scope="module")
def tok_spec():
    return synthetic_llama_tokenizer_json(VOCAB, seed=0)


@pytest.fixture(scope="module")
def tokenizers(tok_spec):
    """(the port's tokenizer, transformers' fast tokenizer on the same
    tokenizer.json)."""
    from tokenizers import Tokenizer
    from transformers import PreTrainedTokenizerFast
    hf = PreTrainedTokenizerFast(
        tokenizer_object=Tokenizer.from_str(json.dumps(tok_spec)),
        bos_token="<s>", eos_token="</s>", unk_token="<unk>")
    return LlamaTokenizer(tok_spec), hf


def _prompt():
    return np.random.default_rng(1).integers(3, VOCAB, (2, PROMPT_LEN))


# ------------------------------------------------------------------ llama

@pytest.fixture(scope="module")
def jax_stream(params):
    """JAX's greedy continuation of the prompt (no EOS) and its fp32
    logits over prompt + continuation, one forward."""
    jm = jax_llama.LlamaForCausalLM(JCFG.text)
    p = {"params": params["llama"]}
    ids = _prompt()
    out = np.asarray(jax.jit(lambda x: jax_llama.greedy_generate(
        jm, p, x, NEW, eos_token_id=NEVER))(jnp.asarray(ids)))
    seq = np.concatenate([ids, out], axis=1)
    logits = np.asarray(jax.jit(lambda x: jm.apply(p, x)[0])(
        jnp.asarray(seq)))
    return ids, out, seq, logits


def test_llama_logits_match_jax(model, jax_stream):
    _, _, seq, want = jax_stream
    with torch.no_grad():
        got, _ = model.llama(torch.from_numpy(seq))
    assert _rel(got.numpy(), want) < REL


def test_greedy_ids_match_jax(model, jax_stream):
    ids, want, _, _ = jax_stream
    got = llama.greedy_generate(model.llama, torch.from_numpy(ids), NEW,
                                eos_token_id=NEVER)
    np.testing.assert_array_equal(got.numpy(), want)


def _cached_logits(lm, seq, prefill: int, kv_quant: bool):
    """Prefill `prefill` tokens into a cache of the whole length, then one
    decode step a token over the whole cache (the unwritten slots masked),
    as greedy_generate runs them."""
    with torch.no_grad():
        cache = llama.init_cache(lm.config, seq.shape[0], seq.shape[1],
                                 kv_quant=kv_quant)
        out, cache = lm(seq[:, :prefill], cache=cache, cache_index=0,
                        attn_len=prefill)
        outs = [out]
        for i in range(prefill, seq.shape[1]):
            out, cache = lm(seq[:, i:i + 1], cache=cache, cache_index=i,
                            attn_len=seq.shape[1])
            outs.append(out)
    return torch.cat(outs, dim=1)


def test_cached_decode_equals_full_forward(model, jax_stream):
    seq = torch.from_numpy(jax_stream[2])
    with torch.no_grad():
        full, _ = model.llama(seq)
    cached = _cached_logits(model.llama, seq, PROMPT_LEN, kv_quant=False)
    assert _rel(cached.numpy(), full.numpy()) < REL


def test_eos_and_pad_follow_jax_semantics(model, jax_stream):
    """EOS is kept, pads (0) follow it, a row without it runs the full
    length, and a batch whose rows are all done stops early: the JAX
    loop's output, derived from its EOS-free stream."""
    ids, stream, _, _ = jax_stream
    k = next(k for k in range(1, NEW) if stream[0, k] not in stream[0, :k])
    eos = int(stream[0, k])
    want = stream.copy()
    for r in range(len(want)):
        hits = np.flatnonzero(want[r] == eos)
        if hits.size:
            want[r, hits[0] + 1:] = 0
    got = llama.greedy_generate(model.llama, torch.from_numpy(ids), NEW,
                                eos_token_id=eos)
    np.testing.assert_array_equal(got.numpy(), want)
    calls = []
    hook = model.llama.register_forward_hook(
        lambda *a: calls.append(1))
    try:
        one = llama.greedy_generate(model.llama, torch.from_numpy(ids[:1]),
                                    NEW, eos_token_id=eos)
    finally:
        hook.remove()
    np.testing.assert_array_equal(one.numpy(), want[:1])
    assert len(calls) == k + 1          # the prefill, then k steps


@pytest.fixture(scope="module")
def jax_int8(params):
    return jax_llama.quantize_llama_params(JCFG.text, params["llama"])


def test_int8_layout_equals_jax(model, jax_int8):
    want = params_from_jax(jax_int8)
    got = llama.quantize_llama_params(CFG.text, model.llama.state_dict())
    assert set(got) == set(want)
    for key, t in got.items():
        assert t.dtype == want[key].dtype, key
        assert torch.equal(t, want[key]), key
    q = llama.LlamaForCausalLM(CFG.text, quant=True)
    q.load_state_dict(got, strict=True)


class KVCodeTape:
    """JAX's int8 codes (the Int8Dense activations and the KV cache's) in
    call order, fed to the port's quantizers in place of their own."""

    def __init__(self):
        self.codes, self.used, self.flips, self.total = [], 0, 0, 0
        self.max_diff = 0

    def record(self, q):
        self.codes.append(np.array(q))

    def _next(self, own):
        want = torch.from_numpy(self.codes[self.used])
        self.used += 1
        assert want.shape == own.shape, (want.shape, own.shape)
        diff = (want.int() - own.int()).abs()
        self.flips += int((diff > 0).sum())
        self.total += diff.numel()
        self.max_diff = max(self.max_diff, int(diff.max()))
        return want

    def replaying(self, mp):
        for mod in (port_layers, llama):
            sym = mod.quantize_symmetric

            def replay(x, dims, keepdim=False, sym=sym):
                q, s = sym(x, dims, keepdim)
                return self._next(q), s
            mp.setattr(mod, "quantize_symmetric", replay)

    def check(self):
        assert self.used == len(self.codes) and self.used > 0
        assert self.max_diff <= 1, self.max_diff
        assert self.flips <= FLIP_SHARE * self.total, (self.flips,
                                                       self.total)


@pytest.mark.parametrize("quant,kv_quant", [(True, False), (True, True),
                                            (False, True)],
                         ids=["int8", "int8_kv", "kv"])
def test_int8_and_kv_quant_logits_match_jax(model, params, jax_int8,
                                            jax_stream, quant, kv_quant):
    seq = jax_stream[2][:, :PROMPT_LEN + INT8_STEPS]
    jparams = jax_int8 if quant else params["llama"]
    state = model.llama.state_dict()
    if quant:
        state = llama.quantize_llama_params(CFG.text, state)
    jm = jax_llama.LlamaForCausalLM(JCFG.text, quant=quant)
    tape = KVCodeTape()

    def jax_cached(x):
        cache = jax_llama.init_cache(JCFG.text, x.shape[0], x.shape[1],
                                     kv_quant=kv_quant)
        p = {"params": jparams}
        out, cache = jm.apply(p, x[:, :PROMPT_LEN], cache=cache,
                              cache_index=0, attn_len=PROMPT_LEN)
        outs = [out]
        for i in range(PROMPT_LEN, x.shape[1]):
            out, cache = jm.apply(p, x[:, i:i + 1], cache=cache,
                                  cache_index=i, attn_len=x.shape[1])
            outs.append(out)
        return jnp.concatenate(outs, axis=1)

    def recording(fn):
        def wrapped(*a, **kw):
            q, s = fn(*a, **kw)
            jax.debug.callback(tape.record, q, ordered=True)
            return q, s
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_layers, "quantize_symmetric",
                   recording(jax_layers.quantize_symmetric))
        mp.setattr(jax_quant, "quantize_symmetric",
                   recording(jax_quant.quantize_symmetric))
        want = np.asarray(jax.jit(jax_cached)(jnp.asarray(seq)))
    lm = llama.LlamaForCausalLM(CFG.text, quant=quant)
    lm.load_state_dict(state, strict=True)
    with pytest.MonkeyPatch.context() as mp:
        tape.replaying(mp)
        got = _cached_logits(lm, torch.from_numpy(seq), PROMPT_LEN,
                             kv_quant=kv_quant)
    tape.check()
    assert _rel(got.numpy(), want) < REL


def test_captioner_int8_conversion_leaves_the_model(model, tokenizers):
    port_tok, _ = tokenizers
    before = model.llama.layers_0.self_attn.q_proj.weight
    cap = captioner.LlavaCaptioner(model, port_tok, max_new_tokens=3,
                                   quant="int8", kv_quant=True)
    assert cap.model.llama.quant and not model.llama.quant
    assert cap.model.mm is model.mm
    assert cap.model.llama.layers_0.self_attn.q_proj.kernel_q.dtype == \
        torch.int8
    assert model.llama.layers_0.self_attn.q_proj.weight is before
    again = captioner.LlavaCaptioner(cap.model, port_tok, max_new_tokens=3,
                                     quant="int8")
    assert again.model is cap.model     # an int8 decoder passes through
    assert isinstance(cap(np.zeros((30, 40, 3), np.uint8))[0], str)
    with pytest.raises(ValueError, match="quant"):
        captioner.LlavaCaptioner(model, port_tok, quant="int4")


# ------------------------------------------------------------------ llava

@pytest.mark.parametrize("hw,size", [((40, 30), 28), ((30, 41), 28),
                                     ((28, 28), 28), ((50, 17), 336)])
def test_preprocess_image_is_jax_pil(hw, size):
    img = np.random.default_rng(hw[0] + size).integers(
        0, 256, hw + (3,), dtype=np.uint8)
    want = jax_llava.preprocess_image(Image.fromarray(img), size)
    got = llava.preprocess_image(img, size)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _faces(n=3, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (30 + 4 * i, 26 + 6 * i, 3),
                         dtype=np.uint8) for i in range(n)]


def test_llava_features_match_jax(model, params):
    pixels = np.concatenate([llava.preprocess_image(f, 28)
                             for f in _faces(2)])
    want = jax.jit(jax_llava.LlavaModel(JCFG).apply)(
        {"params": params["mm"]}, jnp.asarray(pixels))
    with torch.no_grad():
        got = model.mm(torch.from_numpy(pixels))
    assert got.shape == (2, JCFG.num_image_tokens, TEXT["hidden_size"])
    assert _rel(got.numpy(), np.asarray(want)) < REL


@pytest.fixture(scope="module")
def captioners(model, params, tokenizers):
    """The JAX and the port LlavaCaptioner (fp32) on one set of weights,
    the JAX one's ids recorded per call."""
    port_tok, hf_tok = tokenizers
    jcap = jax_captioner.LlavaCaptioner(
        params, hf_tok, config=JCFG, max_new_tokens=CAPTION_TOKENS,
        dtype=jnp.float32)
    jcap.ids = []
    fn = jcap._fn

    def spy(*a):
        out = fn(*a)
        jcap.ids.append(np.asarray(out))
        return out

    jcap._fn = spy
    pcap = captioner.LlavaCaptioner(model, port_tok,
                                    max_new_tokens=CAPTION_TOKENS)
    return jcap, pcap


@pytest.fixture(scope="module")
def face_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("faces")
    for i, face in enumerate(_faces()):
        (root / f"face{i}.png").write_bytes(encode_png(face))
    return root


def test_caption_ids_and_strings_match_jax(captioners, face_dir):
    jcap, pcap = captioners
    paths = sorted(str(p) for p in face_dir.iterdir())[:2]
    jcap.ids.clear()
    want = jcap.caption_batch([Image.open(p) for p in paths])
    got_ids = [pcap.generate_ids(paths, prompt)
               for prompt in (pcap.caption_prompt, pcap.detail_prompt)]
    for g, w in zip(got_ids, jcap.ids):
        np.testing.assert_array_equal(g, w)
    assert pcap.caption_batch(paths) == want


def test_run_caption_json_matches_jax(captioners, face_dir, tmp_path):
    """apps.fgid's caption stage at batch 2 over 3 images (the last chunk
    padded), JAX's and the port's, field for field."""
    from consistentid_tpu.apps import fgid as jax_fgid
    jcap, pcap = captioners
    jax_fgid.run_caption(str(face_dir), str(tmp_path / "jax"), jcap,
                         batch_size=2)
    fgid.run_caption(str(face_dir), str(tmp_path / "port"), pcap,
                     batch_size=2)
    names = sorted(os.listdir(tmp_path / "jax" / "json"))
    assert names == sorted(os.listdir(tmp_path / "port" / "json"))
    assert len(names) == 3
    for name in names:
        want = json.loads((tmp_path / "jax" / "json" / name).read_text())
        got = json.loads((tmp_path / "port" / "json" / name).read_text())
        assert got == want


def test_batched_captions_equal_sequential(captioners):
    _, pcap = captioners
    faces = _faces()
    seq = [pcap.generate(f, captioner.CAPTION_PROMPT) for f in faces]
    assert pcap.generate_batch(faces, captioner.CAPTION_PROMPT) == seq
    assert [c for c, _ in pcap.caption_batch(faces)] == seq


def test_captioner_refuses_jpeg_and_mesh(captioners, model, tmp_path):
    _, pcap = captioners
    path = tmp_path / "face.jpg"
    Image.fromarray(_faces(1)[0]).save(path)
    with pytest.raises(ValueError, match="JPEG"):
        pcap(str(path))
    # a mesh without a model axis keeps the decoder whole; --tp 2 needs a
    # process group of 2 ranks (tests/test_torch_parallel.py runs one)
    from consistentid_torch.parallel import make_mesh
    whole = captioner.LlavaCaptioner(model, pcap.tokenizer,
                                     mesh=make_mesh(device_type="cpu"))
    assert whole.model.llama is model.llama
    with pytest.warns(UserWarning, match="world size 1"), \
            pytest.raises(ValueError, match="2 ranks"):
        captioner.make_captioner(llava_dir=str(tmp_path), tp=2,
                                 device="cpu")


# --------------------------------------------------- converters, loading

@pytest.mark.parametrize("layout", ["modern", "legacy"])
def test_llava_from_hf_matches_jax(model, layout):
    state = model.state_dict()
    hf = {k: v.numpy() for k, v in llava_to_hf(state, CFG, layout).items()}
    assert any(k.startswith("model.language_model.") for k in hf) == \
        (layout == "modern")
    want = jax_cb.llava_from_hf(hf, JCFG)
    got = cb.llava_from_hf(hf, CFG)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, w)
    carried = params_from_jax(want)
    assert set(carried) == set(state)
    assert all(torch.equal(carried[k], state[k]) for k in state)
    names = cb.llava_names_from_hf(hf, CFG)
    assert set(names) == set(state) and set(names.values()) == set(hf)


@pytest.mark.parametrize("layout", ["modern", "legacy"])
def test_from_pretrained_reads_a_written_hf_set(model, captioners, tmp_path,
                                                layout):
    """llava_to_hf's tensors written as two safetensors shards with an
    index and the tokenizer files; `from_pretrained` gives the same
    weights and captions, and JAX's reader and converter read the set
    as the same tree."""
    from consistentid_tpu.io.safetensors_reader import read_checkpoint
    hf = llava_to_hf(model.state_dict(), CFG, layout)
    keys = sorted(hf)
    shards = {"model-00001-of-00002.safetensors": keys[:len(keys) // 2],
              "model-00002-of-00002.safetensors": keys[len(keys) // 2:]}
    weight_map = {}
    for name, part in shards.items():
        write_safetensors_torch(str(tmp_path / name),
                                {k: hf[k] for k in part})
        weight_map.update({k: name for k in part})
    (tmp_path / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {}, "weight_map": weight_map}))
    write_llama_tokenizer(str(tmp_path), VOCAB, seed=0)
    cap = captioner.LlavaCaptioner.from_pretrained(
        str(tmp_path), device="cpu", dtype=torch.float32, config=CFG,
        max_new_tokens=CAPTION_TOKENS)
    loaded = cap.model.state_dict()
    assert all(torch.equal(loaded[k], v)
               for k, v in model.state_dict().items())
    face = _faces(1)[0]
    assert cap(face) == captioners[1](face)
    jtree = jax_cb.llava_from_hf(read_checkpoint(str(tmp_path)), JCFG)
    assert all(torch.equal(params_from_jax(jtree)[k], v)
               for k, v in model.state_dict().items())


def test_tokenizer_model_only_directory_is_refused(tmp_path):
    (tmp_path / "tokenizer.model").write_bytes(b"\x00")
    with pytest.raises(ValueError, match="tokenizer.model"):
        LlamaTokenizer.from_pretrained(str(tmp_path))


# --------------------------------------------------------------- tokenizer

TEXTS = [
    captioner.CAPTION_PROMPT, captioner.DETAIL_PROMPT,
    *jax_captioner.llava_v1_prompt_parts(captioner.CAPTION_PROMPT),
    *jax_captioner.llava_v1_prompt_parts(captioner.DETAIL_PROMPT),
    "Ünïcödé façade: 東京の顔 — naïve café ☕ 🙂",
    "tab\tnew\nline\r\n  two  spaces  ", "", " ", "<s>hi</s>there<unk>",
]


def _metaspace(spec):
    """The newer llava-hf form: no normalizer, a Metaspace pre-tokenizer
    (prepend scheme "first", no split) and decoder, and <image>/<pad>
    added tokens."""
    spec = json.loads(json.dumps(spec))
    spec["normalizer"] = None
    spec["pre_tokenizer"] = {"type": "Metaspace", "replacement": "▁",
                             "prepend_scheme": "first", "split": False}
    spec["decoder"] = {"type": "Metaspace", "replacement": "▁",
                       "prepend_scheme": "first", "split": False}
    n = len(spec["model"]["vocab"])
    for i, t in enumerate(["<image>", "<pad>"]):
        spec["added_tokens"].append(dict(
            id=n + i, content=t, single_word=False, lstrip=False,
            rstrip=False, normalized=False, special=True))
    return spec


@pytest.mark.parametrize("kind", ["llama2", "metaspace"])
def test_tokenizer_matches_tokenizers_library(tok_spec, kind):
    from tokenizers import Tokenizer
    spec = tok_spec if kind == "llama2" else _metaspace(tok_spec)
    ref = Tokenizer.from_str(json.dumps(spec))
    port = LlamaTokenizer(spec)
    texts = TEXTS + ["a <image> b<pad>"]
    for text in texts:
        for special in (True, False):
            want = ref.encode(text, add_special_tokens=special).ids
            assert port.encode(text, add_special_tokens=special) == want, \
                text
    rng = np.random.default_rng(4)
    runs = [rng.integers(0, len(ref.get_vocab()), 60).tolist()
            for _ in range(20)]
    runs += [ref.encode(t).ids for t in texts]
    runs.append([ref.token_to_id("<0xE6>"), ref.token_to_id("<0x9D>"),
                 ref.token_to_id("<0xB1>"), ref.token_to_id("<0xE6>")])
    for ids in runs:
        for skip in (True, False):
            assert port.decode(ids, skip_special_tokens=skip) == \
                ref.decode(ids, skip_special_tokens=skip), ids
    assert port.bos_token_id == 1 and port.eos_token_id == 2
