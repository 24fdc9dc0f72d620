"""Training checkpoints with resume, the counterpart of the JAX package's
io/checkpoint.py (orbax there).

One directory per step under `directory`, named by the step as orbax names
them, holding `state.pt`: the TrainState's `state_dict` (the trainable fp32
masters, AdamW's mu, nu and count, the step; the frozen parameters only
with `save_frozen`), written by `torch.save` into a temporary directory
that is then renamed, so a half-written step is never read. Restoring loads
with `torch.load(weights_only=True)` and copies into an existing TrainState
in place. `export_adapter_numpy` strips the trainable adapter into a flat
numpy dict in the JAX package's key layout (`"proj/..."`).
"""
from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional

import numpy as np

import torch

from ..training.train_step import TrainState, is_trainable_path
from .from_jax import tree_from_module

STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5,
                 save_frozen: bool = False):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_frozen = save_frozen
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        """The steps with a complete checkpoint, in order."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.isfile(
                          os.path.join(self.directory, name, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState) -> str:
        """Write `state` at its step (replacing one of the same step), then
        drop the oldest beyond max_to_keep. Returns the step's
        directory."""
        step = int(state.step)
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".tmp-{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        payload = state.state_dict(frozen=self.save_frozen)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return final

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Load a step (default the latest) into `state` in place and
        return it; without a checkpoint, `state` as it is. The frozen
        parameters stay `state`'s unless they were saved."""
        step = self.latest_step() if step is None else step
        if step is None:
            return state
        payload = torch.load(
            os.path.join(self.directory, str(step), STATE_FILE),
            map_location="cpu", weights_only=True)
        state.load_state_dict(payload)
        return state


def export_adapter_numpy(bundle) -> Dict[str, np.ndarray]:
    """The bundle's trainable adapter (proj, facial_encoder and the UNet's
    LoRA and IP projections: after training, the masters) as a flat numpy
    dict keyed as the JAX package's export, "proj/.../kernel", with its
    leaf layout (io/from_jax.tree_from_module): the analogue of the
    reference's convert_weights.py artifact."""
    params, _ = tree_from_module(bundle, keep=is_trainable_path)
    out: Dict[str, np.ndarray] = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}/")
            else:
                out[f"{prefix}{key}"] = val
    walk(params, "")
    return out
