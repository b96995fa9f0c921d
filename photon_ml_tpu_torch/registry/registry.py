"""Model registry: generation-numbered lineage with validation-gated,
crash-atomic promotion (port of ``photon_ml_tpu/registry/registry.py``;
the on-disk format and the lease file are the same, so a registry that
one package writes the other reads, and their publishers exclude each
other).

Production retraining (ROADMAP "Continuous retraining") republishes a
model every hour into live scoring. The failure modes that matter are
not exotic: a publisher killed mid-copy must never leave a generation
that loaders half-see; two cron ticks overlapping must not interleave
writes; a candidate that failed its validation gates must be
IMPOSSIBLE to load, not merely discouraged. The registry makes each of
those structural:

Layout (one directory per registry)::

    <root>/
        lease.json                  # single-writer lease (exclusive create)
        generations/
            g000001/
                manifest.json       # lineage manifest (see below)
                model/...           # the model artifact, verbatim
                COMMIT              # commit marker: visible iff present
            .staging-<token>/       # in-flight publish (never listed)
        refused/
            <token>/manifest.json   # gate-failed candidates (+ verdict)
        quarantine/
            g000002/...             # rolled-back generations (+ reason)

**Visibility contract.** A generation exists for loaders iff its
directory name parses, ``COMMIT`` is present, and the manifest reads
back. The publish order is: stage everything into a token-unique
``.staging-*`` dir, ``os.replace`` it to its final name, then write
``COMMIT`` atomically. A ``kill -9`` at ANY step therefore leaves
either no trace (staging dirs are invisible) or an uncommitted
directory (invisible: no ``COMMIT``) — never a partial generation.
Every step crosses the ``registry.publish`` fault seam, so the chaos
tests pin exactly that.

**Resume.** A publisher restarted after a crash finds either nothing
(stage again) or an uncommitted generation directory. If its content
signature matches the candidate being published, it is ADOPTED (only
the marker is written — the resumed publish is bitwise the
uninterrupted one); a mismatching uncommitted dir is quarantined and
the publish proceeds fresh.

**Single writer.** ``lease.json`` is taken with an exclusive create
(O_EXCL). A second concurrent publisher fails with
:class:`RegistryLeaseHeld` without having written anything. A lease
whose owner process is dead (the kill-mid-publish case) is broken and
re-taken; a live owner's lease never is.

**Manifests are timestamp-free.** Everything recorded (parent, data
ranges, content signatures, gate verdicts) is a pure function of the
publish inputs, so a resumed publish produces a bitwise-identical
generation directory — the invariant the chaos arm diffs.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import uuid
from dataclasses import dataclass, field
from hashlib import blake2b
from typing import Dict, List, Optional

from photon_ml_tpu_torch.reliability.artifacts import atomic_write_json
from photon_ml_tpu_torch.reliability.retry import io_call, quarantine_artifact

__all__ = [
    "PUBLISH_SEAM",
    "GenerationInfo",
    "ModelRegistry",
    "RegistryLeaseHeld",
    "RefusedCandidate",
    "content_signature",
]

logger = logging.getLogger(__name__)

PUBLISH_SEAM = "registry.publish"

MANIFEST = "manifest.json"
COMMIT = "COMMIT"
MODEL_SUBDIR = "model"
LEASE = "lease.json"
GEN_PREFIX = "g"
GEN_DIGITS = 6


def _flight(kind: str, **fields) -> None:
    """Publication-protocol transitions land in the process flight
    recorder (obs/): lease acquire/release, commit, refusal,
    quarantine — the ordered sequence a kill-mid-publish post-mortem
    reads back."""
    from photon_ml_tpu_torch.obs.flight_recorder import flight_recorder

    flight_recorder().record(kind, **fields)


class RegistryLeaseHeld(RuntimeError):
    """A live publisher holds the registry lease: this publisher loses
    cleanly, having written nothing."""

    def __init__(self, holder: Dict[str, object]):
        super().__init__(
            f"registry lease held by pid {holder.get('pid')} "
            f"on {holder.get('host')} (token {holder.get('token')})"
        )
        self.holder = holder


class RefusedCandidate(RuntimeError):
    """Publish refused by a failed validation gate: the named terminal
    verdict is recorded under ``refused/`` and the candidate is never
    visible to loaders."""

    def __init__(self, verdict: str, refused_dir: str):
        super().__init__(
            f"candidate refused by validation gate {verdict}; manifest "
            f"recorded at {refused_dir}"
        )
        self.verdict = verdict
        self.refused_dir = refused_dir


def content_signature(model_dir: str) -> str:
    """Deterministic digest of a model artifact: blake2b over the sorted
    relative paths and the full bytes of every file. Two directories
    compare equal iff they are bitwise-equal trees — the adopt-or-
    quarantine decision on crash resume, and the lineage record that
    ties a generation to its exact artifact."""
    h = blake2b(digest_size=16)
    for root, dirs, files in sorted(os.walk(model_dir)):
        dirs.sort()
        for name in sorted(files):
            path = os.path.join(root, name)
            rel = os.path.relpath(path, model_dir)
            h.update(rel.encode("utf-8"))
            h.update(b"\0")
            with open(path, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            h.update(b"\0")
    return h.hexdigest()


def _gen_name(generation: int) -> str:
    return f"{GEN_PREFIX}{generation:0{GEN_DIGITS}d}"


def _parse_gen(name: str) -> Optional[int]:
    if not name.startswith(GEN_PREFIX):
        return None
    digits = name[len(GEN_PREFIX):]
    if not digits.isdigit():
        return None
    return int(digits)


@dataclass
class GenerationInfo:
    """One committed generation as loaders see it."""

    generation: int
    path: str          # the generation directory
    model_dir: str     # the model artifact inside it
    manifest: Dict[str, object] = field(default_factory=dict)

    @property
    def parent(self) -> Optional[int]:
        p = self.manifest.get("parent")
        return int(p) if p is not None else None

    @property
    def signature(self) -> str:
        return str(self.manifest.get("signature", ""))

    @property
    def gate_verdict(self) -> str:
        gates = self.manifest.get("gates") or {}
        return str(gates.get("verdict", "UNGATED"))


class _Lease:
    """Exclusive-create writer lease with dead-owner takeover."""

    def __init__(self, root: str):
        self.path = os.path.join(root, LEASE)
        self.token = uuid.uuid4().hex
        self.held = False

    @staticmethod
    def _owner_alive(holder: Dict[str, object]) -> bool:
        import socket

        if str(holder.get("host")) != socket.gethostname():
            # cross-host liveness is unknowable from here: treat the
            # lease as live (a foreign publisher loses rather than two
            # hosts interleaving writes)
            return True
        try:
            pid = int(holder.get("pid", -1))
        except (TypeError, ValueError):
            return False
        if pid <= 0:
            return False
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        except PermissionError:
            return True
        return True

    def _try_create(self) -> bool:  # photon: entropy(lease identity payload; pid+host name the holder, uniqueness is the point)
        import socket

        payload = json.dumps({
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "token": self.token,
        }).encode("utf-8")
        try:
            fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        try:
            os.write(fd, payload)
        finally:
            os.close(fd)
        return True

    def acquire(self) -> None:
        def _acquire():
            if self._try_create():
                return
            try:
                with open(self.path) as f:
                    holder = json.load(f)
            except (OSError, ValueError):
                # torn lease file (killed mid-write): the owner is gone
                # by construction — break it
                holder = {}
            if holder and self._owner_alive(holder):
                raise RegistryLeaseHeld(holder)
            # dead owner (kill-mid-publish): break the lease and retake.
            # The unlink+create race between two breakers resolves to
            # exactly one winner via O_EXCL.
            try:
                os.unlink(self.path)
            except FileNotFoundError:
                pass
            if not self._try_create():
                with open(self.path) as f:
                    raise RegistryLeaseHeld(json.load(f))

        io_call(PUBLISH_SEAM, _acquire, detail=self.path)
        self.held = True
        _flight("registry.lease", action="acquire", path=self.path)

    def release(self) -> None:
        if not self.held:
            return
        self.held = False

        def _release():
            try:
                with open(self.path) as f:
                    holder = json.load(f)
            except (OSError, ValueError):
                return
            if holder.get("token") == self.token:
                try:
                    os.unlink(self.path)
                except FileNotFoundError:
                    pass

        io_call(PUBLISH_SEAM, _release, detail=self.path)
        _flight("registry.lease", action="release", path=self.path)


class ModelRegistry:
    """The registry over one root directory. Loaders (`latest`,
    `list_generations`, `generation`) need no lease and see only
    committed generations; `publish`/`quarantine_generation`/`gc` are
    writer operations behind the single-writer lease."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.generations_dir = os.path.join(self.root, "generations")
        self.refused_dir = os.path.join(self.root, "refused")
        self.quarantine_dir = os.path.join(self.root, "quarantine")

    # -- loader side ---------------------------------------------------------

    def _read_generation(self, name: str) -> Optional[GenerationInfo]:
        gen = _parse_gen(name)
        if gen is None:
            return None
        path = os.path.join(self.generations_dir, name)
        if not os.path.isfile(os.path.join(path, COMMIT)):
            return None  # uncommitted: invisible by contract
        try:
            with open(os.path.join(path, MANIFEST)) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return None  # unreadable manifest: not loadable
        return GenerationInfo(
            generation=gen,
            path=path,
            model_dir=os.path.join(path, MODEL_SUBDIR),
            manifest=manifest,
        )

    def list_generations(self) -> List[GenerationInfo]:
        """Committed generations, ascending. Staging dirs, uncommitted
        dirs, refused candidates and quarantined generations are all
        invisible here — this IS the loader's view."""
        if not os.path.isdir(self.generations_dir):
            return []
        out = []
        for name in sorted(os.listdir(self.generations_dir)):
            info = self._read_generation(name)
            if info is not None:
                out.append(info)
        return out

    def latest(self) -> Optional[GenerationInfo]:
        gens = self.list_generations()
        return gens[-1] if gens else None

    def generation(self, generation: int) -> Optional[GenerationInfo]:
        return self._read_generation(_gen_name(generation))

    def lineage(self, generation: Optional[int] = None) -> List[int]:
        """Parent chain of ``generation`` (default: latest), newest
        first, following manifest ``parent`` pointers through committed
        generations."""
        info = (
            self.latest() if generation is None
            else self.generation(generation)
        )
        chain: List[int] = []
        seen = set()
        while info is not None and info.generation not in seen:
            chain.append(info.generation)
            seen.add(info.generation)
            if info.parent is None:
                break
            info = self.generation(info.parent)
        return chain

    # -- writer side ---------------------------------------------------------

    def _ensure_layout(self) -> None:
        for d in (
            self.root, self.generations_dir, self.refused_dir,
            self.quarantine_dir,
        ):
            os.makedirs(d, exist_ok=True)

    def _uncommitted(self) -> List[str]:
        if not os.path.isdir(self.generations_dir):
            return []
        out = []
        for name in sorted(os.listdir(self.generations_dir)):
            if _parse_gen(name) is None:
                continue
            path = os.path.join(self.generations_dir, name)
            if not os.path.isfile(os.path.join(path, COMMIT)):
                out.append(path)
        return out

    def _next_generation(self) -> int:
        best = 0
        if os.path.isdir(self.generations_dir):
            for name in os.listdir(self.generations_dir):
                gen = _parse_gen(name)
                if gen is not None:
                    best = max(best, gen)
        if os.path.isdir(self.quarantine_dir):
            # a quarantined generation's number is burned: reusing it
            # would let a watcher confuse the replacement for the bad one
            for name in os.listdir(self.quarantine_dir):
                gen = _parse_gen(name.split(".")[0])
                if gen is not None:
                    best = max(best, gen)
        return best + 1

    def publish(
        self,
        model_dir: str,
        *,
        parent: Optional[int] = None,
        data_ranges: Optional[Dict[str, object]] = None,
        gate_report: Optional[Dict[str, object]] = None,
        extra: Optional[Dict[str, object]] = None,
    ) -> GenerationInfo:
        """Publish ``model_dir`` as the next generation.

        A ``gate_report`` with ``verdict != "PASS"`` records the named
        terminal verdict under ``refused/`` and raises
        :class:`RefusedCandidate` — the candidate directory never
        enters ``generations/``. Otherwise the candidate stages,
        renames, and commits, each step behind the
        ``registry.publish`` seam (see the module docstring for the
        crash contract). Returns the committed GenerationInfo.
        """
        self._ensure_layout()
        if not os.path.isdir(model_dir):
            raise ValueError(f"model directory {model_dir} does not exist")
        lease = _Lease(self.root)
        lease.acquire()
        try:
            signature = content_signature(model_dir)
            if gate_report is not None and gate_report.get("verdict") != "PASS":
                return self._refuse(
                    signature, parent, data_ranges, gate_report, extra
                )

            # idempotent republish: a publisher killed AFTER its commit
            # (before lease release) reruns the same command — the
            # already-committed identical candidate IS the publish
            latest = self.latest()
            if latest is not None and latest.signature == signature:
                return latest

            # crash resume: an uncommitted generation whose signature
            # matches this candidate is adopted (commit only — bitwise
            # the uninterrupted publish); a mismatch is quarantined
            adopt: Optional[str] = None
            for path in self._uncommitted():
                try:
                    with open(os.path.join(path, MANIFEST)) as f:
                        m = json.load(f)
                except (OSError, ValueError):
                    m = {}
                if m.get("signature") == signature and adopt is None:
                    adopt = path
                else:
                    io_call(
                        PUBLISH_SEAM, quarantine_artifact, path,
                        PUBLISH_SEAM, detail=path,
                    )
            if adopt is not None:
                gen = _parse_gen(os.path.basename(adopt))
                self._commit(adopt, gen, signature)
                return self._read_generation(os.path.basename(adopt))

            gen = self._next_generation()
            manifest = {
                "generation": gen,
                "parent": parent,
                "signature": signature,
                "data_ranges": data_ranges or {},
                "gates": gate_report or {"verdict": "UNGATED"},
                **(extra or {}),
            }
            staging = os.path.join(
                self.generations_dir, f".staging-{lease.token}"
            )

            def _stage():
                if os.path.isdir(staging):
                    shutil.rmtree(staging)
                os.makedirs(staging)
                shutil.copytree(
                    model_dir, os.path.join(staging, MODEL_SUBDIR)
                )
                atomic_write_json(os.path.join(staging, MANIFEST), manifest)

            io_call(PUBLISH_SEAM, _stage, detail=staging)
            final = os.path.join(self.generations_dir, _gen_name(gen))

            def _rename():
                if os.path.isdir(final):
                    # a racing/crashed publisher left this name behind
                    # uncommitted with a DIFFERENT signature (the
                    # matching case was adopted above): quarantine it
                    quarantine_artifact(final, PUBLISH_SEAM)
                os.replace(staging, final)

            io_call(PUBLISH_SEAM, _rename, detail=final)
            self._commit(final, gen, signature)
            return self._read_generation(_gen_name(gen))
        finally:
            lease.release()

    def _commit(self, path: str, generation: int, signature: str) -> None:
        """The visibility flip: COMMIT lands atomically, after which —
        and only after which — loaders list the generation."""
        io_call(
            PUBLISH_SEAM,
            atomic_write_json,
            os.path.join(path, COMMIT),
            {"generation": generation, "signature": signature},
            detail=os.path.join(path, COMMIT),
        )
        _flight(
            "registry.publish", generation=generation, signature=signature
        )

    def _refuse(
        self, signature, parent, data_ranges, gate_report, extra
    ) -> GenerationInfo:
        verdict = str(gate_report.get("verdict"))
        refused = os.path.join(self.refused_dir, signature)
        manifest = {
            "signature": signature,
            "parent": parent,
            "data_ranges": data_ranges or {},
            "gates": gate_report,
            **(extra or {}),
        }

        def _record():
            os.makedirs(refused, exist_ok=True)
            atomic_write_json(os.path.join(refused, MANIFEST), manifest)

        io_call(PUBLISH_SEAM, _record, detail=refused)
        _flight("registry.refuse", verdict=verdict, signature=signature)
        raise RefusedCandidate(verdict, refused)

    def refused_candidates(self) -> List[Dict[str, object]]:
        """Refusal manifests (debugging/audit; never loadable models)."""
        if not os.path.isdir(self.refused_dir):
            return []
        out = []
        for name in sorted(os.listdir(self.refused_dir)):
            try:
                with open(
                    os.path.join(self.refused_dir, name, MANIFEST)
                ) as f:
                    out.append(json.load(f))
            except (OSError, ValueError) as e:
                logger.warning("unreadable refusal manifest %s: %s", name, e)
        return out

    def quarantine_generation(
        self, generation: int, *, reason: str = ""
    ) -> Optional[str]:
        """Auto-rollback's registry half: move a committed generation to
        ``quarantine/`` so loaders (and the watcher) stop seeing it, and
        record why. Returns the quarantine path (None if the generation
        was not committed)."""
        info = self.generation(generation)
        if info is None:
            return None
        self._ensure_layout()
        dst = os.path.join(self.quarantine_dir, _gen_name(generation))
        n = 0
        while os.path.exists(dst):
            n += 1
            dst = os.path.join(
                self.quarantine_dir, f"{_gen_name(generation)}.{n}"
            )

        def _move():
            os.replace(info.path, dst)
            atomic_write_json(
                os.path.join(dst, "quarantine.json"),
                {"generation": generation, "reason": reason},
            )

        io_call(PUBLISH_SEAM, _move, detail=dst)
        _flight(
            "registry.quarantine", generation=generation, reason=reason
        )
        return dst

    def gc(self, *, keep: int = 5) -> List[int]:
        """Retention: drop committed generations beyond the newest
        ``keep``, EXCEPT any generation still referenced as a parent by
        a retained one (warm-start lineage must stay loadable). Orphaned
        staging dirs are swept too. Returns the removed generation
        numbers."""
        if keep < 1:
            raise ValueError(f"gc keep must be >= 1, got {keep}")
        gens = self.list_generations()
        retained = gens[-keep:]
        referenced = {
            info.parent for info in retained if info.parent is not None
        }
        removed: List[int] = []
        for info in gens[:-keep] if len(gens) > keep else []:
            if info.generation in referenced:
                continue

            def _rm(path=info.path):
                shutil.rmtree(path)

            io_call(PUBLISH_SEAM, _rm, detail=info.path)
            removed.append(info.generation)
        # orphaned staging dirs (crashed publishers) are invisible but
        # not free: sweep any not owned by a live lease holder
        if os.path.isdir(self.generations_dir):
            lease_token = None
            try:
                with open(os.path.join(self.root, LEASE)) as f:
                    holder = json.load(f)
                if _Lease._owner_alive(holder):
                    lease_token = holder.get("token")
            except (OSError, ValueError) as e:
                logger.debug("no live lease during gc sweep: %s", e)
            for name in os.listdir(self.generations_dir):
                if not name.startswith(".staging-"):
                    continue
                if lease_token and name == f".staging-{lease_token}":
                    continue
                shutil.rmtree(
                    os.path.join(self.generations_dir, name),
                    ignore_errors=True,
                )
        return removed
