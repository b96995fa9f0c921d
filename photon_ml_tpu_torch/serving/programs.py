"""Fixed-shape scoring programs over a model bank (port of
``photon_ml_tpu/serving/programs.py``).

Per-request latency is only predictable when nothing in the request
path can build a program: the request path sees exactly
``len(ladder)`` program shapes per model signature — one padded batch
shape per ladder rung — and every one of them is built at bank-load /
swap-stage time, BEFORE the shape can appear on the hot path.

On the card a program is a CUDA graph. For each rung it owns static
input tensors (indices, values, codes, offsets), pinned host staging
of the same shapes and a static output: a dispatch copies the padded
batch into the staging, queues the host-to-device copies and the
graph's replay on the caller's current stream, and hands the static
output to the batcher's one readback. Captures run on a side stream in
``thread_local`` capture mode (a staged swap may capture while the
dispatcher replays the old generation), one at a time, each after an
eager warm-up run; the rungs over one bank share one memory pool. A
capture that fails raises: nothing falls back to eager on the card.

On the CPU (banks built with ``device="cpu"``) the same function runs
eagerly, and a "program" is its per-shape closure; ``compile_count``
then counts program builds, and on the card, captures.

The cache is keyed like the tile-schedule cache: by content signature —
``(bank spec, padded batch shape, partial)`` — plus, on the card, the
addresses of the bank tensors the graph reads. A hot swap with an
unchanged spec copies its values into those same tensors
(`serving/swap.py`), so it captures nothing.

The scoring function replays the batch scorer's per-coordinate algebra
(`game.model_io.LoadedGameModel.score`) term for term — the same gathers
and the same row functions (``data.batch.fe_row_scores``,
``re_row_scores``, ``mf_row_scores``), whose per-row sums follow a fixed
pairwise order that no batch shape changes, and the same accumulation
order over coordinates — which is what makes serving scores
bitwise-equal to the batch driver's at every ladder shape.
"""

from __future__ import annotations

import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.data.batch import fe_row_scores, mf_row_scores, re_row_scores
from photon_ml_tpu_torch.serving.model_bank import ModelBank

__all__ = [
    "RequestBatch",
    "ServingPrograms",
    "DEFAULT_LADDER",
    "select_shape",
    "term_entries",
]

# Padded micro-batch shapes, smallest to largest. 1 serves the idle
# closed loop with no pad waste; 256 is the saturating-load coalescing
# cap (past ~256 rows the per-dispatch fixed cost is already amortized
# to noise and bigger shapes only add tail latency).
DEFAULT_LADDER = (1, 8, 64, 256)

# one capture at a time in the process: captures share the caching
# allocator's pool routing, and a rung's pool is shared with its siblings
_CAPTURE_LOCK = threading.Lock()


def select_shape(n: int, ladder: Sequence[int]) -> int:
    """Smallest ladder shape that fits ``n`` rows (callers cap takes at
    ``max(ladder)``, so there is always one)."""
    for b in ladder:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds the ladder {tuple(ladder)}")


class RequestBatch(NamedTuple):
    """One padded micro-batch: per-shard features, per-id-type entity
    codes, offsets (numpy arrays from the batcher, or tensors). Padded
    rows carry zero features, code -1 and offset 0 — they score finite
    garbage that the demux discards."""

    indices: Dict[str, object]  # shard -> int32 [B, k]
    values: Dict[str, object]  # shard -> float32 [B, k]
    codes: Dict[str, object]  # re/mf id type -> int32 [B]
    offsets: object  # float32 [B]


def _score_spec(spec, arrays, batch: RequestBatch):
    """Margins + offsets for one padded batch of tensors. ``spec`` is the
    bank signature; the loop runs the exact coordinate-order sum the
    batch scorer computes."""
    total = torch.zeros(batch.offsets.shape, device=batch.offsets.device)
    for entry in spec:
        kind, name = entry[0], entry[1]
        if kind == "fe":
            shard_id = entry[2]
            total = total + fe_row_scores(
                arrays[name], batch.indices[shard_id], batch.values[shard_id]
            )
        elif kind == "re":
            re_type, shard_id = entry[2], entry[3]
            total = total + re_row_scores(
                arrays[name], batch.codes[re_type],
                batch.indices[shard_id], batch.values[shard_id],
            )
        else:  # mf
            R, C = arrays[name]
            total = total + mf_row_scores(
                R, C, batch.codes[entry[2]], batch.codes[entry[3]]
            )
    return total + batch.offsets


def term_entries(spec):
    """The ordered (kind, name, id_types, feature_shard) of every
    per-entity spec entry — the coordinate slots a
    :class:`~.admission.PartialScore` carries and a routing tier
    re-sums. MF entries list both id types and no feature shard (their
    term is a latent dot product). Order IS the contract: a router adds
    terms in exactly this sequence, which is the full program's
    accumulation order. That holds only while every fixed-effect entry
    precedes every per-entity one (the partial program sums the FE
    prefix alone), so a spec that interleaves them is refused."""
    out = []
    for entry in spec:
        if entry[0] == "fe" and out:
            raise ValueError(
                f"fixed-effect entry {entry[1]!r} follows a per-entity "
                "entry: a routed FE-then-terms sum would not be the full "
                "program's accumulation order"
            )
        if entry[0] == "re":
            out.append(("re", entry[1], (entry[2],), entry[3]))
        elif entry[0] == "mf":
            out.append(("mf", entry[1], (entry[2], entry[3]), None))
    return tuple(out)


def _score_spec_partial(spec, arrays, batch: RequestBatch):
    """The scatter/gather decomposition of :func:`_score_spec`: the
    fixed-effect accumulation (the identical chain of f32 adds as the
    full program's FE prefix) and one column per re/mf entry with that
    coordinate's term (0.0 where the entity code is -1, exactly the zero
    the full program adds). A router recomposes ``((fe + t_1) + t_2)… +
    offset`` in float32 — each step exactly-rounded IEEE, so the routed
    margin is bitwise the single-server one. Offsets are NOT added here:
    the router owns them."""
    fe = torch.zeros(batch.offsets.shape, device=batch.offsets.device)
    terms = []
    for entry in spec:
        kind, name = entry[0], entry[1]
        if kind == "fe":
            shard_id = entry[2]
            fe = fe + fe_row_scores(
                arrays[name], batch.indices[shard_id], batch.values[shard_id]
            )
        elif kind == "re":
            re_type, shard_id = entry[2], entry[3]
            terms.append(re_row_scores(
                arrays[name], batch.codes[re_type],
                batch.indices[shard_id], batch.values[shard_id],
            ))
        else:  # mf
            R, C = arrays[name]
            terms.append(
                mf_row_scores(R, C, batch.codes[entry[2]], batch.codes[entry[3]])
            )
    stacked = (
        torch.stack(terms, dim=1)
        if terms
        else torch.zeros(batch.offsets.shape + (0,), device=fe.device)
    )
    return fe, stacked


def _batch_shapes(spec, B: int):
    """(indices, values, codes, offsets) of a padded batch at ladder
    shape ``B`` as ``(shape, dtype)`` pairs, the first three by shard or
    id type (shard widths and id types come from the spec)."""
    i32, f32 = torch.int32, torch.float32
    indices: Dict[str, tuple] = {}
    values: Dict[str, tuple] = {}
    codes: Dict[str, tuple] = {}
    for entry in spec:
        kind = entry[0]
        if kind == "fe":
            shard_id, k = entry[2], entry[4]
            indices[shard_id] = ((B, k), i32)
            values[shard_id] = ((B, k), f32)
        elif kind == "re":
            re_type, shard_id, k = entry[2], entry[3], entry[6]
            indices[shard_id] = ((B, k), i32)
            values[shard_id] = ((B, k), f32)
            codes[re_type] = ((B,), i32)
        else:
            for t in (entry[2], entry[3]):
                codes[t] = ((B,), i32)
    return indices, values, codes, ((B,), f32)


def _empty_batch(spec, B: int, **kw) -> RequestBatch:
    """A padded batch of zero tensors at ladder shape ``B``."""
    indices, values, codes, offsets = _batch_shapes(spec, B)

    def _z(sd):
        return torch.zeros(sd[0], dtype=sd[1], **kw)

    return RequestBatch(
        indices={k: _z(v) for k, v in indices.items()},
        values={k: _z(v) for k, v in values.items()},
        codes={k: _z(v) for k, v in codes.items()},
        offsets=_z(offsets),
    )


def _fields(batch: RequestBatch):
    """(kind, key, item) over every array of a batch."""
    for kind in ("indices", "values", "codes"):
        for key, item in getattr(batch, kind).items():
            yield kind, key, item
    yield "offsets", None, batch.offsets


def _field(batch: RequestBatch, kind: str, key):
    return batch.offsets if kind == "offsets" else getattr(batch, kind)[key]


def _flat_arrays(arrays):
    for v in arrays.values():
        yield from v if isinstance(v, tuple) else (v,)


def _binding(arrays) -> Optional[tuple]:
    """The bank tensors a CUDA graph reads, by address (None on the CPU:
    an eager program reads whatever arrays it is handed)."""
    flat = list(_flat_arrays(arrays))
    if not flat or not flat[0].is_cuda:
        return None
    return tuple(
        (a.device.index, a.data_ptr(), tuple(a.shape)) for a in flat
    )


class _EagerProgram:
    """The CPU program: the scoring function, run eagerly per dispatch."""

    def __init__(self, spec, partial: bool):
        self.spec = spec
        self._fn = _score_spec_partial if partial else _score_spec

    def __call__(self, arrays, batch: RequestBatch):
        t = RequestBatch(*(
            {k: torch.as_tensor(v) for k, v in f.items()}
            if isinstance(f, dict) else torch.as_tensor(f)
            for f in batch
        ))
        return self._fn(self.spec, arrays, t)


class _GraphProgram:
    """One CUDA graph for one (spec, B, partial) over one bank's tensors.

    ``__call__`` copies the batch into pinned staging, queues the
    host-to-device copies and the replay on the current stream and
    returns the static output: valid until the next call of this
    program, which is why the batcher reads it back inside its dispatch.
    A program serves one dispatcher at a time (the batcher's dispatch
    thread, under its dispatch lock).
    """

    def __init__(self, spec, arrays, B: int, partial: bool, *,
                 pool, stream: torch.cuda.Stream):
        device = next(_flat_arrays(arrays)).device
        fn = _score_spec_partial if partial else _score_spec
        self._static = _empty_batch(spec, B, device=device)
        self._staging = _empty_batch(spec, B, pin_memory=True)
        # recorded after each dispatch's host-to-device copies: the next
        # dispatch waits on it before it overwrites the pinned staging
        self._copied = torch.cuda.Event()
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            fn(spec, arrays, self._static)  # warm-up, outside the capture
        stream.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(
            self.graph, pool=pool, stream=stream,
            capture_error_mode="thread_local",
        ):
            self._out = fn(spec, arrays, self._static)
        self.pool = self.graph.pool()

    def __call__(self, arrays, batch: RequestBatch):
        self._copied.synchronize()
        for kind, key, dst in _fields(self._static):
            src = _field(batch, kind, key)
            pinned = _field(self._staging, kind, key)
            if torch.is_tensor(src):
                pinned.copy_(src)
            else:
                np.copyto(pinned.numpy(), src, casting="same_kind")
            dst.copy_(pinned, non_blocking=True)
        self._copied.record()
        self.graph.replay()
        return self._out


class ServingPrograms:
    """The per-shape program cache. ``ensure_compiled`` is the warmup
    seam (bank load + swap staging); ``score`` is the hot path and — by
    contract — never builds anything the cache does not already hold
    unless an unwarmed shape arrives (counted, and zero after warmup)."""

    def __init__(self, ladder: Sequence[int] = DEFAULT_LADDER, max_entries: int = 64):
        if not ladder or list(ladder) != sorted(set(int(b) for b in ladder)):
            raise ValueError(
                f"ladder must be strictly increasing and non-empty: {ladder}"
            )
        self.ladder: Tuple[int, ...] = tuple(int(b) for b in ladder)
        self._max_entries = max_entries
        self._lock = threading.Lock()
        # insertion-ordered dict used as an LRU: every hit re-inserts at
        # the end, so eviction (front pop) drops the coldest entry and
        # spec churn can never push out the live bank's ladder rungs
        self._cache: Dict[tuple, object] = {}
        # single-flight guard: key -> Event held by the thread building
        # it, so racing callers wait instead of building redundantly
        self._inflight: Dict[tuple, threading.Event] = {}
        # capture side stream per card (a pool's captures share a stream)
        self._streams: Dict[int, torch.cuda.Stream] = {}
        self.compile_count = 0
        self.cold_dispatch_compiles = 0

    @staticmethod
    def _key(spec, B: int, partial: bool, arrays) -> tuple:
        return (spec, B, bool(partial), _binding(arrays))

    def _lru_get(self, key):  # photon: guarded-by(_lock)
        """Cache lookup + recency touch. Caller holds ``self._lock``."""
        exe = self._cache.get(key)
        if exe is not None:
            self._cache[key] = self._cache.pop(key)
        return exe

    def _build(self, key, spec, arrays, B: int, partial: bool):
        binding = key[3]
        if binding is None:
            return _EagerProgram(spec, partial)
        with self._lock:
            # the rungs over one bank share one memory pool
            pool = next(
                (
                    p.pool for k, p in self._cache.items()
                    if k[0] == spec and k[2] == key[2] and k[3] == binding
                ),
                None,
            )
            dev = binding[0][0]
            stream = self._streams.get(dev)
            if stream is None:
                stream = self._streams[dev] = torch.cuda.Stream(dev)
        with _CAPTURE_LOCK:
            return _GraphProgram(
                spec, arrays, B, partial, pool=pool, stream=stream
            )

    def _get_or_compile(self, spec, arrays, B: int, *,
                        partial: bool = False):
        """Returns ``(program, freshly_built)``. Exactly one thread
        builds a given (spec, B, mode, binding); losers of the race wait
        on the winner's event and take the cached result. If the
        winner's build raises, waiters retry (and may build themselves).
        ``partial`` selects the scatter/gather program (fe +
        per-coordinate terms) over the full-margin one — the two
        families share the LRU, keyed apart."""
        key = self._key(spec, B, partial, arrays)
        while True:
            with self._lock:
                exe = self._lru_get(key)
                if exe is not None:
                    return exe, False
                ev = self._inflight.get(key)
                if ev is None:
                    ev = threading.Event()
                    self._inflight[key] = ev
                    break
            # timed wait: re-check the cache each beat instead of
            # parking unbounded on the winner's event
            while not ev.wait(timeout=0.1):
                continue
        try:
            exe = self._build(key, spec, arrays, B, partial)
            with self._lock:
                while len(self._cache) >= self._max_entries:
                    self._cache.pop(next(iter(self._cache)))
                self._cache[key] = exe
                self.compile_count += 1
            return exe, True
        finally:
            with self._lock:
                self._inflight.pop(key, None)
            ev.set()

    def ensure_compiled(self, bank: ModelBank, *,
                        partial: bool = False) -> int:
        """Build every ladder shape for this bank's signature; returns
        how many programs were newly built (0 when the spec was already
        warm — the swap-without-recapture case). ``partial`` warms the
        shard-server program family instead of the full-margin one."""
        fresh = 0
        for B in self.ladder:
            _, new = self._get_or_compile(
                bank.spec, bank.arrays, B, partial=partial
            )
            fresh += int(new)
        return fresh

    def executable(self, spec, B: int, *, partial: bool = False,
                   arrays=None):
        """The cached program for ``(spec, B)``; on the card pass the
        bank's ``arrays`` (a graph is bound to the tensors it reads)."""
        with self._lock:
            return self._lru_get(
                (spec, B, bool(partial),
                 None if arrays is None else _binding(arrays))
            )

    def _program(self, bank: ModelBank, B: int, partial: bool):
        exe = self.executable(bank.spec, B, partial=partial, arrays=bank.arrays)
        if exe is None:
            # an unwarmed shape reached the hot path: build it now and
            # count the miss — the tests and chip_smoke.py pin this at
            # zero after warmup
            with self._lock:
                self.cold_dispatch_compiles += 1
            exe, _ = self._get_or_compile(
                bank.spec, bank.arrays, B, partial=partial
            )
        return exe

    def score(self, bank: ModelBank, batch: RequestBatch) -> torch.Tensor:
        """Device scores for one padded batch (no readback here — the
        batcher owns the single counted device_get per dispatch)."""
        B = int(batch.offsets.shape[0])
        return self._program(bank, B, False)(bank.arrays, batch)

    def score_partial(self, bank: ModelBank, batch: RequestBatch):
        """Device (fe[B], terms[B, R]) for one padded batch — the
        shard-server half of a routed score. Same no-build-after-warmup
        contract as :meth:`score`; no readback here either."""
        B = int(batch.offsets.shape[0])
        return self._program(bank, B, True)(bank.arrays, batch)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "compiled_programs": len(self._cache),
                "compile_count": self.compile_count,
                "cold_dispatch_compiles": self.cold_dispatch_compiles,
            }
