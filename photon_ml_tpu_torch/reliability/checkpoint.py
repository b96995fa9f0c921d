"""Crash-safe resume state beyond GAME in-memory CD: per-λ grid
snapshots (GLM drivers) and per-iteration streaming-CD snapshots (GAME
streaming driver). Port of ``photon_ml_tpu/reliability/checkpoint.py``
over the same ``.npz`` files and JSON markers, so a snapshot either
package writes loads in the other: the per-λ snapshots, the unified-mesh
grid-bank snapshots (``game/unified.py``) and the streaming CD's (its
caller is ``game/streaming.py``).

The TrainingCheckpointer (utils/checkpoint.py) covers the in-memory GAME
CD loop; these two cover the λ-grid sweep, where a ``kill -9`` would lose
every solved λ, and a streamed GAME run. Both checkpointers follow the
same commit protocol: arrays land in an ``.npz`` written tmp+rename, then a small JSON *commit marker* lands
atomically — a snapshot without its marker (killed between the two
writes) is invisible to resume. All IO runs behind the ckpt_save /
ckpt_restore seams, so chaos plans cover it and transient errors retry.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from photon_ml_tpu_torch.reliability.artifacts import atomic_write_json
from photon_ml_tpu_torch.reliability.manifest import ensure_run_manifest
from photon_ml_tpu_torch.reliability.retry import io_call

__all__ = ["GridCheckpointer", "StreamingCDCheckpointer"]


def _save_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """np.savez to a same-directory temp + rename (np.savez itself can
    be killed mid-write; the published file is always complete)."""
    tmp = f"{path}.{os.getpid()}.tmp.npz"

    def _write():
        np.savez(tmp, **arrays)
        os.replace(tmp, path)

    try:
        io_call("ckpt_save", _write, detail=path)
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass


def _load_npz(path: str) -> Dict[str, np.ndarray]:
    def _read():
        with np.load(path, allow_pickle=False) as z:
            return {k: np.array(z[k]) for k in z.files}

    return io_call("ckpt_restore", _read, detail=path)


def _read_marker(path: str) -> Optional[dict]:
    import json

    if not os.path.isfile(path):
        return None

    def _load():
        with open(path) as f:
            return json.load(f)

    return io_call("ckpt_restore", _load, detail=path)


class GridCheckpointer:
    """Per-λ snapshots for the GLM regularization-path sweeps.

    One snapshot per COMPLETED λ: the warm-start means (optimization
    space — the currency the next λ's solve starts from, so a resumed
    sweep walks bitwise the same iterate chain), the exported model
    (original space), and the OptResult arrays. The run manifest guards
    against resuming a different grid/data/config.
    """

    def __init__(self, directory: str, run_config: Dict[str, object]):
        self.directory = os.path.abspath(directory)
        ensure_run_manifest(self.directory, run_config, kind="glm-grid")

    def _base(self, lam: float) -> str:
        tag = float(lam).hex().replace("0x", "").replace(".", "_")
        return os.path.join(self.directory, f"lambda-{tag}")

    def has(self, lam: float) -> bool:
        return _read_marker(self._base(lam) + ".json") is not None

    def save(
        self,
        lam: float,
        *,
        warm_means: np.ndarray,
        model_means: np.ndarray,
        model_variances: Optional[np.ndarray],
        result_arrays: Dict[str, np.ndarray],
    ) -> None:
        base = self._base(lam)
        arrays = {
            "warm_means": np.asarray(warm_means),
            "model_means": np.asarray(model_means),
        }
        if model_variances is not None:
            arrays["model_variances"] = np.asarray(model_variances)
        for k, v in result_arrays.items():
            if v is not None:
                arrays[f"result__{k}"] = np.asarray(v)
        _save_npz(base + ".npz", arrays)
        # marker last: its atomic publish commits the snapshot
        io_call(
            "ckpt_save", atomic_write_json, base + ".json",
            {"lambda": float(lam)}, detail=base + ".json",
        )

    def load(self, lam: float) -> Optional[Dict[str, object]]:
        base = self._base(lam)
        if _read_marker(base + ".json") is None:
            return None
        arrays = _load_npz(base + ".npz")
        out: Dict[str, object] = {
            "warm_means": arrays["warm_means"],
            "model_means": arrays["model_means"],
            "model_variances": arrays.get("model_variances"),
            "result": {
                k[len("result__"):]: v
                for k, v in arrays.items()
                if k.startswith("result__")
            },
        }
        return out


    # -- unified-mesh grid banks (game/unified.py) ----------------------------
    #
    # The sharded λ-grid bank snapshots in its RAW [G_pad, rows, d]
    # hash-placement layout (GridShardedREBank.snapshot); restore hands the
    # loaded array to GridShardedREBank.restore, which keeps each rank's
    # own block. The marker records the layout, so a snapshot cannot
    # restore onto a different entity-shard count.

    def _grid_base(self, name: str) -> str:
        safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in str(name))
        return os.path.join(self.directory, f"grid-bank-{safe}")

    def has_grid_bank(self, name: str) -> bool:
        return _read_marker(self._grid_base(name) + ".json") is not None

    def save_grid_bank(self, name: str, bank_snapshot: np.ndarray, layout: Dict[str, int]) -> None:
        """Commit a GridShardedREBank.snapshot() array (the same tmp+rename
        npz, then atomic-marker protocol as the per-λ snapshots)."""
        base = self._grid_base(name)
        _save_npz(base + ".npz", {"bank": np.asarray(bank_snapshot)})
        io_call(
            "ckpt_save", atomic_write_json, base + ".json",
            {"name": str(name), "layout": {k: int(v) for k, v in layout.items()}},
            detail=base + ".json",
        )

    def load_grid_bank(
        self, name: str, expect_layout: Optional[Dict[str, int]] = None,
    ) -> Optional[Tuple[np.ndarray, Dict[str, int]]]:
        """(snapshot, layout) for a committed grid bank, or None. With
        ``expect_layout``, a committed snapshot whose recorded layout
        disagrees raises: hash-placed rows restored onto another shard
        count would scramble entity ownership."""
        base = self._grid_base(name)
        marker = _read_marker(base + ".json")
        if marker is None:
            return None
        layout = {k: int(v) for k, v in dict(marker.get("layout") or {}).items()}
        if expect_layout is not None:
            mismatched = {
                k: (layout.get(k), int(v))
                for k, v in expect_layout.items()
                if layout.get(k) != int(v)
            }
            if mismatched:
                raise ValueError(
                    f"grid-bank snapshot {name!r} was written under a "
                    f"different layout: {mismatched} (recorded vs "
                    "expected); re-run with the original mesh shape or "
                    "start fresh"
                )
        arrays = _load_npz(base + ".npz")
        return arrays["bank"], layout


class StreamingCDCheckpointer:
    """Per-iteration snapshots of the streamed GAME coordinate-descent
    state: every coordinate's means/bank (+ variances when tracked) and
    the host-side histories. Iteration k+1 depends ONLY on the states
    after iteration k (scores/residuals recompute deterministically from
    states against the staged chunks), so the iteration boundary is a
    complete resume point."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max(1, int(max_to_keep))

    def _npz(self, it: int) -> str:
        return os.path.join(self.directory, f"iter-{it:06d}.npz")

    def _marker(self, it: int) -> str:
        return os.path.join(self.directory, f"iter-{it:06d}.json")

    def steps(self) -> List[int]:
        out = []
        for fn in os.listdir(self.directory):
            if fn.startswith("iter-") and fn.endswith(".json"):
                try:
                    out.append(int(fn[len("iter-"):-len(".json")]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(
        self,
        it: int,
        states: Dict[str, np.ndarray],
        variances: Dict[str, Optional[np.ndarray]],
        histories: Dict[str, object],
    ) -> None:
        arrays: Dict[str, np.ndarray] = {}
        for name, s in states.items():
            arrays[f"state__{name}"] = np.asarray(s)
        for name, v in variances.items():
            if v is not None:
                arrays[f"var__{name}"] = np.asarray(v)
        _save_npz(self._npz(it), arrays)
        io_call(
            "ckpt_save", atomic_write_json, self._marker(it),
            {"iteration": int(it), "histories": histories},
            detail=self._marker(it),
        )
        for old in self.steps()[: -self.max_to_keep]:
            for path in (self._npz(old), self._marker(old)):
                try:
                    os.unlink(path)
                except OSError:
                    pass

    def load(
        self, it: int
    ) -> Tuple[
        Dict[str, np.ndarray],
        Dict[str, Optional[np.ndarray]],
        Dict[str, object],
    ]:
        marker = _read_marker(self._marker(it))
        if marker is None:
            raise FileNotFoundError(f"no streaming-CD snapshot at {it}")
        arrays = _load_npz(self._npz(it))
        states = {
            k[len("state__"):]: v
            for k, v in arrays.items()
            if k.startswith("state__")
        }
        variances: Dict[str, Optional[np.ndarray]] = {
            name: arrays.get(f"var__{name}") for name in states
        }
        return states, variances, dict(marker.get("histories") or {})
