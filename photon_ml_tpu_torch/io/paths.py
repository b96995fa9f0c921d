"""Input-path expansion shared by the data readers (port of
``photon_ml_tpu/io/paths.py``).

The reference's readers get this from Hadoop's FileInputFormat, which skips
hidden ("." prefix) and marker ("_" prefix, e.g. _SUCCESS) files; daily
dated directories routinely contain both, so the filter is load-bearing for
the date-range path (IOUtils.scala:84+).
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Union


def _visible(fn: str) -> bool:
    return not fn.startswith(".") and not fn.startswith("_")


def expand_input_paths(
    paths: Union[str, Sequence[str]],
    predicate: Optional[Callable[[str], bool]] = None,
) -> List[str]:
    """Expand files-or-directories to a sorted flat file list.

    Directories expand to their visible regular files accepted by
    ``predicate`` (default: all); explicit file paths pass through
    unfiltered (the caller named them on purpose).
    """
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(
                sorted(
                    os.path.join(p, fn)
                    for fn in os.listdir(p)
                    if _visible(fn)
                    and os.path.isfile(os.path.join(p, fn))
                    and (predicate is None or predicate(fn))
                )
            )
        else:
            out.append(p)
    return out
