"""Atomic write-rename for every artifact the drivers emit (port of
``photon_ml_tpu/reliability/artifacts.py``).

A torn ``metrics.json`` (killed mid-``json.dump``) or a half-written
Avro part file is worse than a missing one: the next stage reads garbage
instead of failing cleanly, and a resumed run trusts it. Every artifact
write in the package goes through these helpers: the bytes land in a same-directory temp file and
``os.replace`` publishes them — readers see the old file or the whole
new one, never a prefix. Same-directory matters: ``os.replace`` is only
atomic within a filesystem.
"""

from __future__ import annotations

import json
import os
import tempfile
from contextlib import contextmanager
from typing import IO, Iterator

__all__ = [
    "atomic_writer",
    "atomic_write_json",
    "atomic_write_bytes",
    "atomic_write_text",
]


@contextmanager
def atomic_writer(
    path: str, mode: str = "w", **open_kwargs
) -> Iterator[IO]:
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
        except OSError:  # photon: allow(PL006) — best-effort tmp cleanup on the error path; the original exception re-raises below
            pass
        raise


def atomic_write_json(path: str, payload, *, indent: int = 2) -> None:
    with atomic_writer(path, "w") as f:
        json.dump(payload, f, indent=indent)


def atomic_write_bytes(path: str, data: bytes) -> None:
    with atomic_writer(path, "wb") as f:
        f.write(data)


def atomic_write_text(path: str, text: str, encoding: str = "utf-8") -> None:
    with atomic_writer(path, "w", encoding=encoding) as f:
        f.write(text)
