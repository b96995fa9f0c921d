"""Run/store manifests: the compatibility guard + progress record that
makes crash-safe resume trustworthy (port of
``photon_ml_tpu/reliability/manifest.py``; the same ``manifest.json``).

Two jobs:

- :func:`ensure_run_manifest` — refuse to resume into a directory
  produced by a DIFFERENT run configuration. Resuming foreign weights or
  foreign staged chunks would silently corrupt the result; a changed
  config must get a fresh directory (the shared, atomic form of the
  GAME driver's guard that every resume path uses).
- :func:`write_manifest` / :func:`read_manifest` — the per-store
  progress record (staged chunk count, rows consumed, fill-pass flags)
  updated atomically after each completed unit of work, so a ``kill -9``
  leaves either the old manifest or the new one — never a torn record.
  A store without a readable manifest is treated as absent and rebuilt.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

from photon_ml_tpu_torch.reliability.artifacts import atomic_write_json
from photon_ml_tpu_torch.reliability.retry import io_call

__all__ = [
    "MANIFEST_NAME",
    "write_manifest",
    "read_manifest",
    "ensure_run_manifest",
]

MANIFEST_NAME = "manifest.json"


def write_manifest(
    directory: str, payload: Dict[str, object], *, seam: str = "ckpt_save"
) -> None:
    path = os.path.join(directory, MANIFEST_NAME)
    io_call(seam, atomic_write_json, path, payload, detail=path)


def read_manifest(
    directory: str, *, seam: str = "ckpt_restore"
) -> Optional[Dict[str, object]]:
    path = os.path.join(directory, MANIFEST_NAME)
    if not os.path.isfile(path):
        return None

    def _load():
        with open(path) as f:
            return json.load(f)

    try:
        return io_call(seam, _load, detail=path)
    except (ValueError, json.JSONDecodeError):
        # a torn/garbage manifest means the store cannot be trusted:
        # quarantine it (accounted) and rebuild from source
        from photon_ml_tpu_torch.reliability.retry import quarantine_artifact

        quarantine_artifact(path, seam)
        return None


def ensure_run_manifest(
    directory: str, config: Dict[str, object], *, kind: str
) -> Dict[str, object]:
    """Create-or-verify the run manifest: a fresh directory records
    ``config``; an existing one must match it exactly (the resume
    compatibility contract). Returns the manifest on disk. Progress keys
    (anything outside "config"/"kind") are preserved on verify."""
    os.makedirs(directory, exist_ok=True)
    existing = read_manifest(directory)
    if existing is not None:
        if existing.get("kind") != kind or existing.get("config") != config:
            raise ValueError(
                f"{kind} directory {directory} was created by a different "
                "run configuration (inputs, shards, grid, or sequence "
                "changed); point it somewhere fresh or delete it. Recorded "
                f"config: {os.path.join(directory, MANIFEST_NAME)}"
            )
        return existing
    manifest: Dict[str, object] = {"kind": kind, "config": config}
    write_manifest(directory, manifest)
    return manifest
