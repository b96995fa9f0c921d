"""Shared serving fixtures for the port's tests (``tests/test_torch_serving*.py``):
GAME-shaped records and a loaded model made with numpy from a seed, and
the port's own batch scorer as the bitwise reference. Imports nothing of
JAX."""

from __future__ import annotations

import json
import socket
import time

import numpy as np

from photon_ml_tpu_torch.game.config import FeatureShardConfiguration
from photon_ml_tpu_torch.game.model_io import LoadedGameModel
from photon_ml_tpu_torch.serving import build_model_bank
from photon_ml_tpu_torch.task import TaskType

SHARDS = [
    FeatureShardConfiguration("g", ["features"]),
    FeatureShardConfiguration("u", ["userFeatures"]),
]


def synth_records(rng, n=60, n_users=7, d_g=5, d_u=3):
    recs = []
    for i in range(n):
        u = int(rng.integers(0, n_users))
        recs.append({
            "uid": f"r{i}",
            "response": float(rng.integers(0, 2)),
            "offset": float(rng.normal() * 0.1),
            "weight": float(rng.uniform(0.5, 2.0)),
            "metadataMap": {"userId": f"user{u}"},
            "features": [
                {"name": f"g{j}", "term": "", "value": float(rng.normal())}
                for j in range(d_g)
            ],
            "userFeatures": [
                {"name": f"u{j}", "term": "", "value": float(rng.normal())}
                for j in range(d_u)
            ],
        })
    return recs


def synth_model_dicts(rng, n_users=7, d_g=5, d_u=3, *, scale=1.0, drop_user=True):
    """(fixed effects, random effects) of a LoadedGameModel as plain dicts:
    one FE and one per-user RE coordinate; one user deliberately has NO
    model (the unknown-entity path)."""
    fixed = {
        "global": (
            "g", {f"g{j}\t": float(rng.normal()) * scale for j in range(d_g)},
        )
    }
    users = range(n_users - 1) if drop_user else range(n_users)
    random = {
        "per-user": (
            "userId",
            "u",
            {
                f"user{e}": {
                    f"u{j}\t": float(rng.normal()) * scale for j in range(d_u)
                }
                for e in users
            },
        )
    }
    return fixed, random


def synth_model(rng, **kw):
    lm = LoadedGameModel()
    lm.fixed_effects, lm.random_effects = synth_model_dicts(rng, **kw)
    return lm


def batch_reference_scores(lm, ds):
    """What the port's batch scoring driver writes: raw scores + offsets."""
    scores = lm.score(ds, TaskType.LOGISTIC_REGRESSION) + ds.row_tensors()[1]
    return scores.cpu().numpy()[: ds.num_real_rows]


def index_maps_and_widths(ds):
    imaps = {sid: sd.index_map for sid, sd in ds.shards.items()}
    widths = {sid: sd.indices.shape[1] for sid, sd in ds.shards.items()}
    return imaps, widths


def make_bank(lm, ds, **kw):
    imaps, widths = index_maps_and_widths(ds)
    kw.setdefault("device", "cpu")
    return build_model_bank(lm, imaps, widths, **kw)


def wait_until(cond, timeout=5.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return False


class Client:
    """One JSON-lines client connection with bounded reads."""

    def __init__(self, port, timeout=15.0):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=timeout)
        self.reader = self.sock.makefile("rb")

    def send_line(self, obj_or_bytes):
        data = (
            obj_or_bytes
            if isinstance(obj_or_bytes, bytes)
            else (json.dumps(obj_or_bytes) + "\n").encode()
        )
        self.sock.sendall(data)

    def recv(self):
        line = self.reader.readline()
        return json.loads(line) if line else None

    def ask(self, obj):
        self.send_line(obj)
        return self.recv()

    def close(self):
        try:
            self.reader.close()
            self.sock.close()
        except OSError:
            pass
