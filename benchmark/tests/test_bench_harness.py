"""CPU tests of the benchmark harness (benchmark/), at toy sizes:

    python -m pytest benchmark/tests -q

Names resolve, the result line has the contract's keys, the yardstick's
arithmetic matches hand sums, the open loop's schedule repeats from its
seed, no module imports JAX or the JAX package, the reference imports
nothing of the system, each number's control reads above the system's
reading, and a run with the served path broken underneath comes out not
correct. The card test (marked `cuda`) skips here.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402
from benchmark.harness import yardstick  # noqa: E402
from benchmark.harness.spec import (Cell, load_cell, load_mode,  # noqa
                                    load_reader, read_json)
from benchmark.reference.stepwise import NUMBERS, PARTS  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "consistentid_tpu"}
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device",
               "checks"}
TINY_LIMITS = {"start": 0.0, "parse": 0.0, "embed": 1e-4, "cond": 1e-3,
               "cond.id": 1e-3, "cond.face": 1e-3, "unet": 1e-3,
               "unet.mid_attn": 1e-3, "step": 1e-5, "image": 1e-2}


def tiny_cell(limits=TINY_LIMITS, requests=2) -> Cell:
    """sd15-serve-saturated's metrics over a toy configuration and mix."""
    bench = read_json(ROOT / "BENCHMARK.json")
    name = "sd15-serve-saturated"
    return Cell(name, bench, {"name": name, "chips": 1},
                {"check": {"requests": requests, "limits": dict(limits),
                           "probes": ["mid_attn", "up_3_attn_1"],
                           "probe_steps": [0, 2]}},
                read_json(BENCH / "tests" / "tiny_sd15.json"),
                read_json(BENCH / "tests" / "tiny_closed.json"))


def tiny_run(seed=2 ** 40 + 5, seconds=3.0):
    return run.run_cell(tiny_cell(), seed, seconds, False, device="cpu")


def imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_every_cell_and_metric_resolves():
    bench = read_json(ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        mode = load_mode(cell.traffic["mode"])
        assert callable(mode.make) and callable(mode.first_round)
        check = cell.workload["check"]
        probes = {f"unet.{b}" for b in check.get("probes", ())}
        assert set(check["limits"]) <= set(NUMBERS) | set(PARTS) | probes
        for kind in ("end_to_end", "per_layer"):
            for m in cell.metrics(kind):
                assert callable(load_reader(m["name"]))
        assert any(m["name"] == "setup_s" for m in cell.metrics("end_to_end"))
        assert len(cell.metrics("end_to_end")) >= 2
        assert cell.metrics("per_layer")
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in imports(path) if m}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_reference_imports_nothing_of_the_system():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in imports(path) if m}
        assert "consistentid_torch" not in tops, path
        assert "benchmark" not in tops, path


def test_attention_bound_matches_hand_sums():
    # b=2, h=3, sq=sk=64, d=8, bf16: bytes 2*(2*3*64*8*2) * 2, FLOPs 4bhsd
    qo = 2 * 3 * 64 * 8 * 2
    want = max(4 * qo / yardstick.PEAK_HBM_BYTES_PER_S,
               4 * 2 * 3 * 64 * 64 * 8 / yardstick.PEAK_BF16_FLOPS)
    assert yardstick.attention_bound_s(2, 3, 64, 64, 8, 2) == want
    big = yardstick.attention_bound_s(16, 8, 4096, 4096, 40, 2)
    assert big == 4 * 16 * 8 * 4096 * 4096 * 40 / 989e12


def test_self_attention_shapes_of_sd15_and_sdxl():
    sd15 = read_json(BENCH / "configs" / "sd15.json")["unet"]
    assert yardstick.self_attention_shapes(sd15, 512, 512) == [
        (5, 8, 4096, 40), (5, 8, 1024, 80)]
    sdxl = read_json(BENCH / "configs" / "sdxl.json")["unet"]
    assert yardstick.self_attention_shapes(sdxl, 1024, 1024) == [
        (10, 10, 4096, 64), (60, 20, 1024, 64)]


def test_flop_count_matches_hand_sum_of_a_text_tower():
    cfg = read_json(BENCH / "tests" / "tiny_sd15.json")
    flops = yardstick.request_flops(cfg, {"height": 64, "width": 64,
                                          "steps": 3})
    d, f, s, layers = 64, 128, 77, 2
    per_layer = (4 * 2 * s * d * d          # q, k, v, out projections
                 + 2 * 2 * s * s * d        # Q K^T and P V over the heads
                 + 2 * 2 * s * d * f)       # fc1, fc2
    assert flops["text"] == 3 * layers * per_layer
    assert flops["unet"] > 0 and flops["vae_decode"] > 0


def test_open_loop_schedule_repeats_from_its_seed():
    schedule = load_mode("serve_open").poisson_schedule
    a = schedule(2 ** 40 + 11, 1.5, 51.0)
    assert a == schedule(2 ** 40 + 11, 1.5, 51.0)
    assert a != schedule(2 ** 40 + 12, 1.5, 51.0)
    assert all(0 <= x < 51.0 for x in a) and a == sorted(a)
    assert 40 < len(a) < 120


def test_result_line_has_the_contract_keys():
    out, lines = tiny_run()
    assert set(out) == RESULT_KEYS
    assert list(out)[-1] == "checks"
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"images_per_min", "setup_s"}
    json.dumps(out)
    assert lines[-1].startswith("failed_requests")


def test_controls_read_above_the_system():
    """Each number's control at a toy size (calibrate.py): the system's
    int8 path for unet, the reference's fp8-rounded towers for cond, its
    bf16 sampler update for step and its fp8-rounded decoder for image,
    each at least three times the system's own reading."""
    from benchmark.calibrate import calibrate
    _, readings = calibrate(tiny_cell(), [2 ** 40 + 21], 1, device="cpu",
                            emit=lambda line: None)
    for n in ("cond", "cond.id", "cond.face", "unet", "unet.mid_attn",
              "step", "image"):
        assert readings[f"{n}_upper"] >= 3 * max(readings[f"{n}_lower"],
                                                 1e-12), (n, readings)


def broken(monkeypatch, fault):
    from consistentid_torch.pipelines import consistentid_sd15 as sd15
    if fault == "state_unchanged":
        real = sd15.denoise

        def denoise(unet_fn, latents, text_b, facial_b, plan, *a, **k):
            plan = dataclasses.replace(plan,
                                       coef_x=np.ones_like(plan.coef_x),
                                       coef_e=np.zeros_like(plan.coef_e))
            return real(unet_fn, latents, text_b, facial_b, plan, *a, **k)

        monkeypatch.setattr(sd15, "denoise", denoise)
    elif fault == "half_batch":
        real = sd15.ConsistentIDPipeline._generate_core

        def core(self, cond, latents, *a, **k):
            half = max(1, latents.shape[0] // 2)
            latents = latents[:half].repeat(
                (latents.shape[0] + half - 1) // half, 1, 1, 1)[
                    :latents.shape[0]]
            return real(self, cond, latents, *a, **k)

        monkeypatch.setattr(sd15.ConsistentIDPipeline, "_generate_core",
                            core)
    elif fault == "facial_fusion_skipped":
        from consistentid_torch.adapter import modules

        def fuse(self, prompt_embeds, *a, **k):
            return prompt_embeds

        monkeypatch.setattr(modules.FuseModule, "forward", fuse)
    elif fault == "id_tokens_zeroed":
        from consistentid_torch.adapter import modules
        real = modules.ProjPlusModel.forward

        def proj(self, *a, **k):
            return torch.zeros_like(real(self, *a, **k))

        monkeypatch.setattr(modules.ProjPlusModel, "forward", proj)
    elif fault == "answer_altered":
        real = sd15.ConsistentIDPipeline._check

        def check(self, out):
            out = real(self, out)
            return np.clip(out.astype(np.int16) + 8, 0, 255).astype(np.uint8)

        monkeypatch.setattr(sd15.ConsistentIDPipeline, "_check", check)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "facial_fusion_skipped",
                                   "id_tokens_zeroed", "answer_altered"])
def test_a_broken_served_path_is_not_correct(monkeypatch, fault):
    broken(monkeypatch, fault)
    out, _ = tiny_run()
    assert out["correct"] is False, (fault, out["checks"])


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out, _ = run.run_cell(load_cell("sd15-serve-saturated"), 2 ** 33 + 7,
                          20.0, False)
    assert out["correct"], out["checks"]
