"""LibSVM text reader (port of ``photon_ml_tpu/io/libsvm.py``).

Reference: photon-ml .../io/LibSVMInputDataFormat.scala:43-75 — lines of
``label idx:value idx:value ...``; indices are 1-based in the classic
format; labels in {-1,+1} or {0,1} are mapped to {0,1}. Feature keys become
``str(idx)`` names with empty terms so one IndexMap vocabulary serves both
input formats.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Tuple

from photon_ml_tpu_torch.io.paths import expand_input_paths
from photon_ml_tpu_torch.utils.index_map import feature_key

Row = Tuple[List[int], List[float]]


def parse_libsvm_line(
    line: str, *, zero_based: bool = False
) -> Optional[Tuple[float, List[Tuple[int, float]]]]:
    """-> (label, [(index, value), ...]) or None for blank/comment lines."""
    line = line.split("#", 1)[0].strip()
    if not line:
        return None
    parts = line.split()
    label = float(parts[0])
    if label < 0:  # {-1,+1} -> {0,1}
        label = 0.0
    pairs = []
    for tok in parts[1:]:
        idx_s, _, val_s = tok.partition(":")
        idx = int(idx_s)
        if not zero_based:
            idx -= 1
        pairs.append((idx, float(val_s)))
    return label, pairs


def read_libsvm(
    paths, *, zero_based: bool = False
) -> Iterator[Tuple[float, List[Tuple[int, float]]]]:
    """Iterate (label, [(index, value)]) over one or many files;
    directories expand to their visible regular files (hidden and
    underscore-marker files like _SUCCESS are skipped)."""
    for path in expand_input_paths(paths):
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parsed = parse_libsvm_line(line, zero_based=zero_based)
                if parsed is not None:
                    yield parsed


def libsvm_feature_keys(
    examples: Iterable[Tuple[float, List[Tuple[int, float]]]]
) -> Iterator[str]:
    """The feature key of every entry of the parsed rows, in order (the
    vocabulary an IndexMap is built from)."""
    for _, pairs in examples:
        for idx, _ in pairs:
            yield feature_key(str(idx))
