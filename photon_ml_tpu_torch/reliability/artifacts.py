"""Atomic write-rename for the artifacts the driver emits (port of
``atomic_writer`` and ``atomic_write_json`` from
``photon_ml_tpu/reliability/artifacts.py``).

A torn ``metrics.json`` or a half-written Avro file is worse than a
missing one: the next stage reads garbage instead of failing cleanly. The
bytes land in a same-directory temp file and ``os.replace`` publishes
them, so readers see the old file or the whole new one, never a prefix.
"""

from __future__ import annotations

import json
import os
import tempfile
from contextlib import contextmanager
from typing import IO, Iterator


@contextmanager
def atomic_writer(path: str, mode: str = "w", **open_kwargs) -> Iterator[IO]:
    """Open a temp file next to ``path``; rename over it on clean exit,
    unlink the temp on error. ``mode`` is "w" or "wb"."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        prefix=os.path.basename(path) + ".", suffix=".tmp", dir=parent
    )
    try:
        with os.fdopen(fd, mode, **open_kwargs) as f:
            yield f
            f.flush()
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass  # best effort; the original exception re-raises below
        raise


def atomic_write_json(path: str, payload, *, indent: int = 2) -> None:
    with atomic_writer(path, "w") as f:
        json.dump(payload, f, indent=indent)
