"""Feature indexing job: build partitioned native index stores from data
(port of ``photon_ml_tpu/cli/feature_indexing_driver.py``; host work, no
card).

    python -m photon_ml_tpu_torch.cli.feature_indexing_driver \\
        --input-paths DIR[,DIR...] --output-dir OUT [--format AVRO|LIBSVM]

Reference: photon-ml FeatureIndexingJob.scala:59-136 — a separate Spark job
that hash-partitions distinct feature names and builds per-partition PalDB
name<->index stores (with per-shard maps for GAME). Here the stores are
the native mmap format (native/index_store.cpp) built on host.
"""

from __future__ import annotations

import argparse
import os
from typing import Iterable, Iterator

from photon_ml_tpu_torch.io.avro_codec import read_avro_records
from photon_ml_tpu_torch.io.libsvm import read_libsvm
from photon_ml_tpu_torch.utils.index_map import feature_key, intercept_key
from photon_ml_tpu_torch.utils.native_index import build_partitioned_index


def _avro_keys(paths, feature_bags) -> Iterator[str]:
    for record in read_avro_records(paths):
        for bag in feature_bags:
            for f in record.get(bag) or []:
                yield feature_key(f["name"], f["term"])


def _libsvm_keys(paths) -> Iterator[str]:
    for _, pairs in read_libsvm(paths):
        for idx, _ in pairs:
            yield feature_key(str(idx))


def run_feature_indexing(
    input_paths,
    output_dir: str,
    *,
    data_format: str = "AVRO",
    feature_bags: Iterable[str] = ("features",),
    num_partitions: int = 1,
    add_intercept: bool = True,
    shard_name: str = "global",
) -> str:
    """Build the partitioned store for one feature shard; returns its
    directory (``<output>/<shard_name>``)."""
    if data_format.upper() == "AVRO":
        keys: Iterator[str] = _avro_keys(input_paths, list(feature_bags))
    elif data_format.upper() == "LIBSVM":
        keys = _libsvm_keys(input_paths)
    else:
        raise ValueError(f"unknown format {data_format}")

    def with_intercept(it):
        yield from it
        if add_intercept:
            yield intercept_key()

    shard_dir = os.path.join(output_dir, shard_name)
    pm = build_partitioned_index(
        with_intercept(keys), shard_dir, num_partitions=num_partitions
    )
    pm.close()
    return shard_dir


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m photon_ml_tpu_torch.cli.feature_indexing_driver")
    ap.add_argument("--input-paths", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--format", default="AVRO")
    ap.add_argument("--feature-bags", default="features")
    ap.add_argument("--num-partitions", type=int, default=1)
    ap.add_argument("--add-intercept", default="true")
    ap.add_argument("--shard-name", default="global")
    ns = ap.parse_args(argv)
    shard_dir = run_feature_indexing(
        ns.input_paths.split(","),
        ns.output_dir,
        data_format=ns.format,
        feature_bags=[b for b in ns.feature_bags.split(",") if b],
        num_partitions=ns.num_partitions,
        add_intercept=str(ns.add_intercept).lower() in ("true", "1"),
        shard_name=ns.shard_name,
    )
    print(shard_dir)


if __name__ == "__main__":
    main()
