"""Feature name-and-term list files: per-section feature vocabularies
(port of ``photon_ml_tpu/io/name_term_list.py``, host Python).

Reference: photon-ml .../avro/data/NameAndTermFeatureSetContainer.scala —
a directory with one subdirectory per feature section key holding text
files of ``name TAB term`` lines (one feature per line, term optional,
:101-126); the GAME drivers' default (pre-PalDB) feature-map source
(cli/game/GAMEDriver.scala:49-69 prepareFeatureMapsDefault): a shard's
index map is the union of its section keys' feature sets, indexed
deterministically, with an optional intercept appended. The container's
``main`` is a standalone list-generation job over response-prediction
Avro data (:128-160) — here :func:`generate_name_and_term_lists`.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Mapping, Sequence, Set

from photon_ml_tpu_torch.utils.index_map import IndexMap, feature_key


def read_name_and_term_set(path: str) -> Set[str]:
    """One section directory (or file) -> set of feature keys.
    Lines are ``name TAB term`` or just ``name`` (empty term)."""
    from photon_ml_tpu_torch.io.paths import expand_input_paths

    keys: Set[str] = set()
    for p in expand_input_paths([path]):
        with open(p, "r", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                parts = line.split("\t")
                if len(parts) == 1:
                    keys.add(feature_key(parts[0]))
                elif len(parts) == 2:
                    keys.add(feature_key(parts[0], parts[1]))
                else:
                    raise ValueError(
                        f"{p}: expected 'name' or 'name<TAB>term', got "
                        f"{line!r}"
                    )
    return keys


def read_name_and_term_feature_sets(
    input_dir: str, section_keys: Iterable[str]
) -> Dict[str, Set[str]]:
    """``<input_dir>/<sectionKey>`` per section -> {section: feature keys}
    (readNameAndTermFeatureSetContainerFromTextFiles)."""
    out: Dict[str, Set[str]] = {}
    for section in section_keys:
        path = os.path.join(input_dir, section)
        if not os.path.exists(path):
            raise OSError(
                f"no feature list for section {section!r} at {path}"
            )
        out[section] = read_name_and_term_set(path)
    return out


def save_name_and_term_feature_sets(
    sets: Mapping[str, Iterable[str]], output_dir: str
) -> None:
    """{section: feature keys} -> one text file per section
    (saveAsTextFiles layout: ``<output_dir>/<section>/part-00000``)."""
    for section, keys in sets.items():
        d = os.path.join(output_dir, section)
        os.makedirs(d, exist_ok=True)
        from photon_ml_tpu_torch.reliability.artifacts import atomic_writer

        with atomic_writer(
            os.path.join(d, "part-00000"), encoding="utf-8"
        ) as f:
            for key in sorted(set(keys)):
                f.write(key + "\n")  # key is already name<TAB>term


def index_map_from_sections(
    sets: Mapping[str, Set[str]],
    section_keys: Sequence[str],
    *,
    add_intercept: bool = True,
) -> IndexMap:
    """Union of the given sections' feature sets -> IndexMap
    (getFeatureNameAndTermToIndexMap; deterministic sorted order instead
    of the reference's set-iteration order, intercept last)."""
    union: Set[str] = set()
    for section in section_keys:
        union |= sets[section]
    return IndexMap.build(union, add_intercept=add_intercept)


def index_maps_from_name_term_lists(
    path: str, feature_shards
) -> Dict[str, IndexMap]:
    """{shard_id: IndexMap} for a list of FeatureShardConfiguration —
    the drivers' --feature-name-and-term-set-path source (union of each
    shard's section lists, per-shard intercept flag)."""
    all_sections = sorted({b for cfg in feature_shards for b in cfg.feature_bags})
    sets = read_name_and_term_feature_sets(path, all_sections)
    return {
        cfg.shard_id: index_map_from_sections(
            sets, list(cfg.feature_bags), add_intercept=cfg.add_intercept
        )
        for cfg in feature_shards
    }


def generate_name_and_term_lists(
    input_paths,
    section_keys: Sequence[str],
    output_dir: str,
) -> Dict[str, Set[str]]:
    """Scan Avro data's feature bags and write per-section list files
    (the NameAndTermFeatureSetContainer.main job analog). Returns the
    sets it wrote."""
    from photon_ml_tpu_torch.io.avro_codec import read_avro_records

    sets: Dict[str, Set[str]] = {s: set() for s in section_keys}
    for record in read_avro_records(input_paths):
        for section in section_keys:
            for f in record.get(section) or []:
                sets[section].add(feature_key(f["name"], f["term"]))
    save_name_and_term_feature_sets(sets, output_dir)
    return sets
