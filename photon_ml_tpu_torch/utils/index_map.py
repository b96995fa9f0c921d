"""Feature index maps: bidirectional name<->index lookup (port of
``photon_ml_tpu/utils/index_map.py``; the off-heap ``PartitionedIndexMap``
is in ``utils/native_index.py``).

Reference: photon-ml .../util/IndexMap.scala:23-44 (getIndex /
getFeatureName) and DefaultIndexMap(|Loader).scala (in-heap
collect-distinct-zipWithIndex build, GLMSuite.scala:160-187).

Feature keys are ``name + "\\t" + term`` (Utils.getFeatureKey semantics);
the intercept uses ``("(INTERCEPT)", "")``.
"""

from __future__ import annotations

import itertools
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.reliability.artifacts import atomic_writer

DELIMITER = "\t"
INTERCEPT_NAME = "(INTERCEPT)"
INTERCEPT_TERM = ""


def feature_key(name: str, term: str = "") -> str:
    """name TAB term (Utils.getFeatureKey)."""
    return f"{name}{DELIMITER}{term}"


def intercept_key() -> str:
    return feature_key(INTERCEPT_NAME, INTERCEPT_TERM)


def split_feature_key(key: str):
    name, _, term = key.partition(DELIMITER)
    return name, term


class IndexMap:
    """Bidirectional map feature-key <-> dense index."""

    def __init__(self, name_to_index: Dict[str, int]):
        self._fwd = name_to_index
        self._rev: Optional[List[Optional[str]]] = None

    def __len__(self) -> int:
        return len(self._fwd)

    def __contains__(self, key: str) -> bool:
        return key in self._fwd

    @property
    def size(self) -> int:
        return len(self._fwd)

    def get_index(self, key: str, default: int = -1) -> int:
        return self._fwd.get(key, default)

    def get_indices(self, keys: Sequence[str]) -> np.ndarray:
        """int64 indices of ``keys`` (-1 where absent) in one pass."""
        return np.fromiter(
            map(self._fwd.get, keys, itertools.repeat(-1)), np.int64, count=len(keys)
        )

    def get_feature_name(self, index: int) -> Optional[str]:
        if self._rev is None:
            rev: List[Optional[str]] = [None] * (max(self._fwd.values(), default=-1) + 1)
            for k, i in self._fwd.items():
                rev[i] = k
            self._rev = rev
        if 0 <= index < len(self._rev):
            return self._rev[index]
        return None

    def items(self):
        return self._fwd.items()

    @staticmethod
    def build(
        keys: Iterable[str],
        *,
        add_intercept: bool = False,
    ) -> "IndexMap":
        """Deterministic build: sorted distinct keys -> [0, n)
        (the collect-distinct-zipWithIndex of GLMSuite.scala:160-187, made
        order-independent by sorting). The intercept, when requested, gets
        the LAST index so feature blocks stay contiguous."""
        distinct = sorted(set(keys) - {intercept_key()})
        fwd = {k: i for i, k in enumerate(distinct)}
        if add_intercept:
            fwd[intercept_key()] = len(distinct)
        return IndexMap(fwd)

    # -- persistence (a light JSON text store) ----

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with atomic_writer(path, encoding="utf-8") as f:
            json.dump(self._fwd, f)

    @staticmethod
    def load(path: str):
        """-> IndexMap; an IdentityIndexMap for the descriptor that
        ``IdentityIndexMap.save`` writes; a PartitionedIndexMap for the
        store pointer that ``PartitionedIndexMap.save`` writes (the
        driver's feature-index output under ``--offheap-indexmap-dir``)."""
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        if isinstance(data, dict) and "offheap_index_store" in data:
            from photon_ml_tpu_torch.utils.native_index import PartitionedIndexMap

            return PartitionedIndexMap.from_pointer(data, path)
        if isinstance(data, dict) and "identity_index_map" in data:
            return IdentityIndexMap(
                int(data["identity_index_map"]),
                add_intercept=bool(data.get("add_intercept")),
            )
        return IndexMap(data)


class IdentityIndexMap:
    """Index map for pre-indexed data (IdentityIndexMapLoader analog):
    keys ARE stringified indices. ``add_intercept`` appends the intercept
    at the LAST index (the reference's trueFeatureDimension =
    featureDimension + 1, LibSVMInputDataFormat.scala:39)."""

    def __init__(self, size: int, *, add_intercept: bool = False):
        self._features = size
        self._size = size + (1 if add_intercept else 0)
        self._intercept = size if add_intercept else None

    def __len__(self) -> int:
        return self._size

    @property
    def size(self) -> int:
        return self._size

    def get_index(self, key: str, default: int = -1) -> int:
        if self._intercept is not None and key == intercept_key():
            return self._intercept
        name, _term = split_feature_key(key) if DELIMITER in key else (key, "")
        try:
            i = int(name)
        except ValueError:
            return default
        return i if 0 <= i < self._features else default

    def get_feature_name(self, index: int) -> Optional[str]:
        if self._intercept is not None and index == self._intercept:
            return intercept_key()
        if 0 <= index < self._features:
            return feature_key(str(index))
        return None

    def items(self):
        for i in range(self._features):
            yield feature_key(str(i)), i
        if self._intercept is not None:
            yield intercept_key(), self._intercept

    def save(self, path: str) -> None:
        """A small descriptor instead of materializing stringified
        indices; IndexMap.load reconstructs the identity map from it."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with atomic_writer(path, encoding="utf-8") as f:
            json.dump(
                {
                    "identity_index_map": self._features,
                    "add_intercept": self._intercept is not None,
                },
                f,
            )
