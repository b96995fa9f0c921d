"""Step-level checkpoint / resume for GAME coordinate descent (port of
``photon_ml_tpu/utils/checkpoint.py``).

Photon ML has no mid-optimization checkpointing: its recovery units are
saved models and warm starts (ModelTraining.scala:183-208,
CoordinateDescent.scala:82-87). This module keeps every coordinate's
model state per CD iteration, resumable across process restarts.

The JAX package writes its steps with orbax; the port writes each step as
one ``.npz`` (``<dir>/<step>/state.npz``, keys ``<coordinate>/<array>``)
behind the same protocol: numbered step directories published by an
atomic rename (a killed save leaves no step), ``max_to_keep`` pruning, a
``cd_meta.json`` sidecar, and every read and write behind the
``ckpt_restore`` / ``ckpt_save`` seams. orbax's format is its own, so the
two packages' step files do not load in each other; the drivers' run
manifests and the GridCheckpointer's snapshots do.
"""

from __future__ import annotations

import json
import os
import shutil
from dataclasses import replace
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.reliability.artifacts import atomic_write_json
from photon_ml_tpu_torch.reliability.retry import io_call

STATE_FILE = "state.npz"
META_FILE = "cd_meta.json"


def model_state(model) -> Dict[str, torch.Tensor]:
    """The array state of any GAME submodel, by name."""
    from photon_ml_tpu_torch.game.coordinate import FactoredRandomEffectModel
    from photon_ml_tpu_torch.game.model import (
        FixedEffectModel,
        MatrixFactorizationModel,
        RandomEffectModel,
    )

    if isinstance(model, FixedEffectModel):
        return {"means": model.model.means}
    if isinstance(model, RandomEffectModel):
        return {"bank": model.bank}
    if isinstance(model, FactoredRandomEffectModel):
        return {"bank": model.bank, "projection": model.projection}
    if isinstance(model, MatrixFactorizationModel):
        return {"row_latent": model.row_latent, "col_latent": model.col_latent}
    raise ValueError(f"cannot checkpoint model type {type(model)}")


def restore_model(model, state: Dict[str, Any]):
    """A submodel of ``model``'s type and device from checkpointed
    arrays; the template's type selects the path, and a state of another
    configuration raises."""
    from photon_ml_tpu_torch.game.coordinate import FactoredRandomEffectModel
    from photon_ml_tpu_torch.game.model import (
        FixedEffectModel,
        MatrixFactorizationModel,
        RandomEffectModel,
    )
    from photon_ml_tpu_torch.models.coefficients import Coefficients

    def like(t: torch.Tensor, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=t.device)

    if isinstance(model, FixedEffectModel) and "means" in state:
        means = like(model.model.means, state["means"])
        return replace(model, model=replace(model.model, coefficients=Coefficients(means)))
    sharded = getattr(model, "sharded_bank", None)
    if sharded is not None and "bank" in state:
        # a pod model restores whole; its coordinate shards it on the next
        # update (reading the template's bank would be a collective)
        return RandomEffectModel(
            torch.as_tensor(np.asarray(state["bank"]), device=sharded.data.device),
            model.re_dataset, model.random_effect_type, model.feature_shard_id,
        )
    if isinstance(model, RandomEffectModel) and "bank" in state:
        return replace(model, bank=like(model.bank, state["bank"]))
    if isinstance(model, FactoredRandomEffectModel) and "projection" in state:
        return replace(
            model,
            bank=like(model.bank, state["bank"]),
            projection=like(model.projection, state["projection"]),
        )
    if isinstance(model, MatrixFactorizationModel) and "row_latent" in state:
        return replace(
            model,
            row_latent=like(model.row_latent, state["row_latent"]),
            col_latent=like(model.col_latent, state["col_latent"]),
        )
    raise ValueError(f"checkpoint state {list(state)} does not match {type(model)}")


class TrainingCheckpointer:
    """Per-CD-iteration checkpoints of every coordinate's model state,
    keyed by step (the iteration count)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max(1, int(max_to_keep))

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def save(self, step: int, models: Dict[str, Any]) -> None:
        """Write the step into a temp directory, then rename it into
        place (an existing step of that number is replaced), so a retried
        or killed save never leaves a partial step; then prune."""
        arrays = {
            f"{name}/{key}": t.detach().cpu().numpy()
            for name, m in models.items()
            for key, t in model_state(m).items()
        }
        final = self._step_dir(step)

        def _save():
            tmp = f"{final}.{os.getpid()}.tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            try:
                with open(os.path.join(tmp, STATE_FILE), "wb") as f:
                    np.savez(f, **arrays)
                if os.path.isdir(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)

        io_call("ckpt_save", _save, detail=f"{self.directory} step {step}")
        for old in self.available_steps()[: -self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def available_steps(self) -> List[int]:
        return sorted(
            int(name) for name in os.listdir(self.directory)
            if name.isdigit() and os.path.isfile(os.path.join(self.directory, name, STATE_FILE))
        )

    def latest_step(self) -> Optional[int]:
        steps = self.available_steps()
        return steps[-1] if steps else None

    # -- host-side metadata sidecar (best-iteration tracking) ----------------
    def save_meta(self, meta: Dict[str, Any]) -> None:
        """A small JSON sidecar next to the steps: resume needs more than
        weights (which iteration was validation-best)."""
        path = os.path.join(self.directory, META_FILE)
        io_call("ckpt_save", atomic_write_json, path, meta, detail=path)

    def load_meta(self) -> Optional[Dict[str, Any]]:
        path = os.path.join(self.directory, META_FILE)
        if not os.path.isfile(path):
            return None

        def _load():
            with open(path) as f:
                return json.load(f)

        return io_call("ckpt_restore", _load, detail=path)

    def restore(self, step: int, models: Dict[str, Any]) -> Dict[str, Any]:
        """-> {name: restored model}, with ``models`` as type and device
        templates."""
        path = os.path.join(self._step_dir(step), STATE_FILE)

        def _load():
            with np.load(path, allow_pickle=False) as z:
                return {k: np.array(z[k]) for k in z.files}

        arrays = io_call("ckpt_restore", _load, detail=f"{self.directory} step {step}")
        state: Dict[str, Dict[str, np.ndarray]] = {}
        for key, a in arrays.items():
            name, field = key.rsplit("/", 1)
            state.setdefault(name, {})[field] = a
        return {name: restore_model(models[name], state[name]) for name in models}

    def close(self) -> None:
        """Nothing to release (the JAX package closes its orbax manager)."""
