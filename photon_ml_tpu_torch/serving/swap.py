"""Hot swap: stage a new model generation under live traffic, flip
between micro-batches, roll back on a poisoned artifact (port of
``photon_ml_tpu/serving/swap.py``).

Model publication must never stall the serving loop. Staging therefore
does ALL the slow work — artifact load (behind the
``serving.model_load`` reliability seam), dense bank assembly, device
placement, and the program captures for every ladder shape — while the
previous generation keeps serving. The flip is a reference assignment
under the manager lock; the batcher reads the reference once per
dispatch, so a generation change lands exactly on a micro-batch
boundary.

When the new generation's signature matches the old one's (same
coordinate shapes — the common retrain case, which the entity-axis
padding in `model_bank` is designed to preserve), the flip copies the
staged values into generation N's device tensors in place, under the
dispatch lock (the reference's donating refresh, a bitwise move: a
``copy_`` carries the exact bits, -0.0 included). Steady-state device
memory holds one bank, and the CUDA graphs captured over those tensors
read the new values at the same addresses, so such a swap captures
nothing. A swap whose signature changes captures its whole ladder at
stage time, while the old generation still serves.

Entity-set changes are safe under an in-place swap: requests carry RAW
entity ids and the batcher resolves them to bank rows per dispatch
(serving/batcher.py), so a generation whose entity set differs inside
the same padded bucket never scores stale rows.

A corrupt artifact (decode failure or an injected ``CORRUPT`` at the
seam) quarantines the model directory to ``*.corrupt`` via the
reliability layer and ROLLS BACK: the previous generation keeps
serving, the failure is accounted, and nothing about the request path
changes.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Mapping, Optional

import torch

from photon_ml_tpu_torch.obs.flight_recorder import flight_recorder
from photon_ml_tpu_torch.serving.model_bank import (
    DEFAULT_ENTITY_PAD,
    ModelBank,
    build_model_bank,
    place_on_device,
)
from photon_ml_tpu_torch.serving.programs import ServingPrograms
from photon_ml_tpu_torch.utils.device import DeviceLike, resolve_device

__all__ = ["SwapResult", "ServingModel", "SEAM", "load_model_artifact"]

SEAM = "serving.model_load"


def load_model_artifact(model_dir: str):
    """Read a GAME model directory behind the ``serving.model_load``
    seam: transient IO errors retry on the per-seam budget; a corrupt
    artifact quarantines to ``*.corrupt`` and raises (callers with a
    live previous generation catch and roll back instead)."""
    from photon_ml_tpu_torch.reliability import InjectedCorruption, io_call
    from photon_ml_tpu_torch.reliability.retry import quarantine_artifact

    try:
        return io_call(SEAM, _load_model, model_dir, detail=model_dir)
    except (InjectedCorruption, ValueError) as e:
        quarantine_artifact(model_dir, SEAM)
        raise RuntimeError(
            f"model artifact at {model_dir} is corrupt (quarantined): {e}"
        ) from e


def _refresh_in_place(old_arrays, new_arrays) -> None:
    """Copy generation N+1's values into generation N's tensors: a
    bitwise move into the addresses the captured programs read."""
    for name, old in old_arrays.items():
        new = new_arrays[name]
        for o, n in zip(
            old if isinstance(old, tuple) else (old,),
            new if isinstance(new, tuple) else (new,),
        ):
            o.copy_(n)


@dataclass
class SwapResult:
    ok: bool
    generation: int
    donated: bool = False
    recompiled_programs: int = 0
    rolled_back: bool = False
    quarantined: Optional[str] = None
    error: str = ""


class ServingModel:
    """Generation manager: owns the current ModelBank, the program
    cache, and the stage/flip/rollback protocol."""

    def __init__(
        self,
        bank: ModelBank,
        programs: Optional[ServingPrograms] = None,
        *,
        partial: bool = False,
        entity_shard=None,
    ):
        from photon_ml_tpu_torch import ownership

        if bank.device is None:
            raise ValueError(
                "ServingModel serves a placed bank; build it with a device"
            )
        # partial=True is SHARD-SERVER mode: the ladder holds the
        # scatter/gather program family (fe + per-coordinate terms)
        # instead of full margins, and entity_shard=(s, n) makes every
        # staged generation load the same 1/n slice of the entity axis
        # this server owns (the shared ownership rule).
        self.partial = bool(partial)
        self.entity_shard = ownership.validate_entity_shard(entity_shard)
        self._lock = threading.Lock()
        # Serializes whole stage/flip protocols. Swaps arrive from more
        # than one thread (operator ops on a connection thread, the
        # driver's --swap-after-requests): two concurrent flips would
        # both read the same `prev`, both mint generation prev+1, and on
        # the in-place path both would write prev's tensors. Staging is
        # slow on purpose (artifact load, captures); holding this lock
        # across it only serializes swaps, never the request path
        # (dispatch takes dispatch_lock, not this).
        self._stage_lock = threading.Lock()
        self._bank = bank
        self.programs = programs or ServingPrograms()
        self.programs.ensure_compiled(bank, partial=self.partial)
        self.swap_history = []
        # a bank staged by prepare_swap, waiting for commit_prepared
        # (the two-step flip); read/written only under _stage_lock
        self._prepared: Optional[ModelBank] = None
        # Mutual exclusion between an in-place flip and an in-flight
        # dispatch: the refresh rewrites generation N's tensors, so it
        # must not run while a dispatch is executing against them.
        # MicroBatcher picks this lock up automatically from a bound
        # `ServingModel.current` bank_ref and holds it for the duration
        # of each dispatch; the flip takes it for the device-to-device
        # copy — the "flipped atomically between requests" contract.
        self.dispatch_lock = threading.Lock()

    # the batcher's bank_ref
    def current(self) -> ModelBank:
        with self._lock:
            return self._bank

    @property
    def generation(self) -> int:
        return self.current().generation

    def ready(self) -> bool:
        """Readiness: the current bank is live (not retired) and every
        ladder rung holds a built program for its spec and tensors — a
        ready service can answer ANY admissible batch shape without a
        hot-path build. Distinct from liveness (the dispatcher
        heartbeat, owned by the batcher): a service can be alive but
        not yet ready (mid-staging) and must not take traffic."""
        bank = self.current()
        if bank.retired:
            return False
        return all(
            self.programs.executable(
                bank.spec, B, partial=self.partial, arrays=bank.arrays
            ) is not None
            for B in self.programs.ladder
        )

    def quarantine_re(self, re_type: str) -> None:
        """Operator/fault-path entry: mark one RE coordinate of the
        CURRENT generation unusable. Requests touching it score FE-only
        (degraded), everything else is unaffected — the graceful-
        degradation contract, scoped to this generation (the next swap
        installs a clean bank)."""
        self.current().quarantine_re(re_type)

    @classmethod
    def load(
        cls,
        model_dir: str,
        index_maps: Mapping[str, object],
        shard_widths: Mapping[str, int],
        *,
        ladder=None,
        entity_pad_to: int = DEFAULT_ENTITY_PAD,
        native_index_threshold: Optional[int] = None,
        model_id: str = "",
        partial: bool = False,
        entity_shard=None,
        device: DeviceLike = None,
    ) -> "ServingModel":
        """Initial load: the artifact read runs behind the
        ``serving.model_load`` seam (transient IO errors retry on the
        per-seam budget); a corrupt artifact quarantines and raises —
        with no previous generation there is nothing to roll back to."""
        loaded = load_model_artifact(model_dir)
        bank = build_model_bank(
            loaded,
            index_maps,
            shard_widths,
            generation=1,
            entity_pad_to=entity_pad_to,
            native_index_threshold=native_index_threshold,
            model_id=model_id,
            entity_shard=entity_shard,
            device=resolve_device(device),
        )
        programs = (
            ServingPrograms(ladder) if ladder is not None else None
        )
        return cls(
            bank, programs, partial=partial, entity_shard=entity_shard
        )

    def _load_staged(
        self,
        prev: ModelBank,
        model_dir: str,
        entity_pad_to: int,
        native_index_threshold: Optional[int],
        model_id: str,
    ):
        """Artifact -> host staging bank, or the failed SwapResult (the
        artifact quarantined when corrupt; a transient give-up leaves it
        where it is)."""
        from photon_ml_tpu_torch.reliability import (
            InjectedCorruption,
            SeamFailure,
            io_call,
        )
        from photon_ml_tpu_torch.reliability.retry import quarantine_artifact

        try:
            loaded = io_call(SEAM, _load_model, model_dir, detail=model_dir)
        except (InjectedCorruption, ValueError) as e:
            q = quarantine_artifact(model_dir, SEAM)
            return None, self._abort(prev, str(e), quarantined=q)
        except SeamFailure as e:
            return None, self._abort(prev, str(e))
        staged = build_model_bank(
            loaded,
            index_maps=prev.index_maps,
            shard_widths=prev.shard_widths,
            generation=prev.generation + 1,
            entity_pad_to=entity_pad_to,
            native_index_threshold=native_index_threshold,
            device=False,  # host arrays: placement happens in the flip
            model_id=model_id,
            entity_shard=self.entity_shard,
        )
        return staged, None

    def _abort(self, prev: ModelBank, error: str, *,
               quarantined: Optional[str] = None) -> SwapResult:
        result = SwapResult(
            ok=False,
            generation=prev.generation,
            rolled_back=True,
            quarantined=quarantined,
            error=error,
        )
        self.swap_history.append(result)
        flight_recorder().record(
            "swap.abort",
            error=result.error,
            rolled_back=result.rolled_back,
            quarantined=result.quarantined,
        )
        return result

    def stage_and_swap(
        self,
        model_dir: str,
        *,
        entity_pad_to: int = DEFAULT_ENTITY_PAD,
        native_index_threshold: Optional[int] = None,
        model_id: str = "",
    ) -> SwapResult:
        """Load generation N+1, stage it on the device, warm its
        programs, flip. Never raises on a bad artifact: quarantines +
        rolls back, returning the failure in the SwapResult."""
        # one swap protocol at a time: `prev` read, staging and the
        # flip happen under _stage_lock so racing swap requests
        # serialize instead of both staging against the same predecessor
        with self._stage_lock:
            prev = self.current()
            staged, failed = self._load_staged(
                prev, model_dir, entity_pad_to, native_index_threshold,
                model_id,
            )
            if failed is not None:
                return failed
            return self._flip(staged)

    def swap_to_bank(self, staged: ModelBank) -> SwapResult:
        """Flip to an already-built bank (in-memory publication path —
        e.g. a co-located trainer handing over arrays directly)."""
        with self._stage_lock:
            prev = self.current()
            staged.generation = prev.generation + 1
            return self._flip(staged)

    # -- two-step flip -------------------------------------------------------

    def prepare_swap(
        self,
        model_dir: str,
        *,
        entity_pad_to: int = DEFAULT_ENTITY_PAD,
        native_index_threshold: Optional[int] = None,
        model_id: str = "",
    ) -> SwapResult:
        """Step 1 of the two-step flip: load + build the next
        generation's bank and warm its programs, but DO NOT serve it. A
        fleet stages on every server first and commits only once ALL of
        them staged OK. A failed stage quarantines/rolls back exactly
        like :meth:`stage_and_swap`; a successful one parks the bank for
        :meth:`commit_prepared` (re-preparing replaces it)."""
        with self._stage_lock:
            prev = self.current()
            staged, failed = self._load_staged(
                prev, model_dir, entity_pad_to, native_index_threshold,
                model_id,
            )
            if failed is not None:
                return failed
            return self._park_prepared(staged)

    def prepare_swap_bank(self, staged: ModelBank) -> SwapResult:
        """Step 1 over an already-built host bank (in-memory publication
        / synthetic fleets)."""
        with self._stage_lock:
            return self._park_prepared(staged)

    def _place(self, prev: ModelBank, staged: ModelBank) -> None:
        staged.arrays = place_on_device(staged.arrays, prev.device)
        staged.device = prev.device

    def _park_prepared(self, staged: ModelBank) -> SwapResult:  # photon: guarded-by(_stage_lock)
        # ALL the slow work happens now, while the previous generation
        # keeps serving: device placement and, for a changed spec, the
        # captures. The later commit is the flip stage_and_swap performs.
        prev = self.current()
        staged.generation = prev.generation + 1
        self._place(prev, staged)
        donated = staged.spec == prev.spec
        recompiled = self.programs.ensure_compiled(
            prev if donated else staged, partial=self.partial
        )
        self._prepared = staged
        flight_recorder().record(
            "swap.stage", generation=staged.generation, donated=donated,
        )
        return SwapResult(
            ok=True,
            generation=staged.generation,
            donated=donated,
            recompiled_programs=recompiled,
        )

    def commit_prepared(self) -> SwapResult:
        """Step 2: flip to the bank :meth:`prepare_swap` parked. With
        nothing prepared (or after :meth:`abort_prepared`) this is a
        named failure, never a silent no-op."""
        with self._stage_lock:
            staged = self._prepared
            self._prepared = None
            prev = self.current()
            if staged is None:
                result = SwapResult(
                    ok=False,
                    generation=prev.generation,
                    error="no prepared generation to commit",
                )
                self.swap_history.append(result)
                flight_recorder().record(
                    "swap.abort",
                    error=result.error,
                    rolled_back=result.rolled_back,
                    quarantined=result.quarantined,
                )
                return result
            # re-number against the CURRENT generation: another swap
            # may have landed between prepare and commit
            staged.generation = prev.generation + 1
            return self._flip(staged)

    def abort_prepared(self) -> bool:
        """Drop a parked generation. Returns whether anything was
        parked."""
        with self._stage_lock:
            had = self._prepared is not None
            self._prepared = None
        if had:
            flight_recorder().record("swap.abort", reason="router abort")
        return had

    def _flip(self, staged: ModelBank) -> SwapResult:  # photon: guarded-by(_stage_lock)
        prev = self.current()
        if staged.device != prev.device:
            self._place(prev, staged)
        donated = staged.spec == prev.spec
        if donated:
            # same shapes: refresh in place. The slow work happens
            # before the lock (placement above; the ladder is warm for
            # prev's tensors, normally all cache hits); only the
            # device-to-device copy and the reference flip run under
            # dispatch_lock — exclusive with dispatch, because a batch
            # mid-execution must not see its bank rewritten.
            recompiled = self.programs.ensure_compiled(
                prev, partial=self.partial
            )
            with self.dispatch_lock:
                _refresh_in_place(prev.arrays, staged.arrays)
                if prev.device.type == "cuda":
                    torch.cuda.current_stream(prev.device).synchronize()
                staged.arrays = prev.arrays
                with self._lock:
                    self._bank = staged
                    prev.retired = True
        else:
            # changed shapes: fresh tensors (both generations coexist
            # briefly); prev stays valid, no exclusion needed. Every
            # ladder shape is captured BEFORE the flip: a swap can slow
            # staging, never the first post-swap request.
            recompiled = self.programs.ensure_compiled(
                staged, partial=self.partial
            )
            with self._lock:
                self._bank = staged
                prev.retired = True
        result = SwapResult(
            ok=True,
            generation=staged.generation,
            donated=donated,
            recompiled_programs=recompiled,
        )
        self.swap_history.append(result)
        flight_recorder().record(
            "swap.commit", generation=staged.generation, donated=donated,
        )
        return result


def _load_model(model_dir: str):
    from photon_ml_tpu_torch.game.model_io import load_game_model

    return load_game_model(model_dir)
