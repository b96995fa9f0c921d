"""PL008 unguarded-shared-state: every mutable attribute of a
thread-plane class obeys ONE declared (or inferred) guard discipline.

PRs 7-10 made the repo genuinely concurrent — dispatcher, accept loop,
per-connection reader/writer pairs, registry watcher, decode-ahead
workers — and every bitwise-serving invariant now rests on shared
state being touched correctly. This rule turns that discipline into a
machine-checked contract, the way veScale's analyzer treats SPMD
consistency (PAPERS.md): declare the guard once, and the checker proves
every access obeys it.

Per class (package pass, ``lint/core.py``):

- **Inferred guards.** An attribute written under ``with self._lock:``
  anywhere (outside ``__init__``) is lock-guarded; every OTHER access
  outside ``__init__`` must hold the same lock — a bare read of a
  guarded flag is a stale-decision bug waiting for a preemption point.
  Conditions alias the lock they were constructed over, so
  ``with self._nonempty:`` guards what ``with self._lock:`` guards.
- **Declared guards.** ``# photon: guarded-by(<lock>)`` on the
  ``__init__`` assignment pins the discipline explicitly (the analyzer
  enforces the declaration — it is NOT a suppression).
  ``# photon: guarded-by(atomic)`` declares single-writer
  atomic-publish instead: plain reference assignment only (``+=`` and
  in-place container mutation are flagged), reads free. Use it for
  heartbeat timestamps and copy-on-write snapshots, not as an
  escape hatch.
- **Thread-shared bare attrs.** In a class that spawns a thread
  (``Thread(target=self._loop)``), an attribute mutated on one side of
  the thread boundary and touched on the other with NO lock anywhere is
  flagged even though no guard exists to infer — that is exactly the
  ``_watching_swap``-style state flag this rule exists for.
- **Thread escapes.** A closure handed to ``Thread(target=...)`` /
  ``submit_io`` whose captured local is mutated bare on both sides of
  the spawn is an escaped shared object; lambdas as thread targets are
  rejected outright (unanalyzable capture).

Lock/Condition/Event/Queue attributes are exempt (they ARE the
synchronization), as is anything only touched in ``__init__`` /
``__post_init__`` (pre-publication construction).
"""

from __future__ import annotations

from typing import Iterator, Set, Tuple

from photon_ml_tpu_torch.lint.core import (
    ATOMIC,
    ClassModel,
    PackageContext,
    PackageRule,
    Violation,
    register_package,
)


def _class_violations(model: ClassModel) -> Iterator[Violation]:
    lock_like = model.lock_names() | model.safe_attrs
    shared = model.shared_attrs()
    seen: Set[Tuple[int, str]] = set()

    def emit(access, message):
        key = (getattr(access.node, "lineno", 0), access.attr)
        if key in seen:
            return None
        seen.add(key)
        return model.ctx.violation(RULE, access.node, message)

    for attr in sorted(model.accesses):
        if attr in lock_like or attr in model.methods:
            continue
        accs = [a for a in model.accesses[attr] if not a.in_init]
        if not accs:
            continue
        ann = model.annotations.get(attr)
        if ann == ATOMIC:
            for a in accs:
                if a.kind in ("augwrite", "mutate"):
                    v = emit(a, (
                        f"'{model.name}.{attr}' is declared "
                        "guarded-by(atomic) but this is a read-modify-"
                        "write — atomic discipline allows only plain "
                        "reference assignment (publish a fresh object "
                        "instead, or guard with a lock)"
                    ))
                    if v:
                        yield v
            continue
        if ann is not None:
            target = model.resolve_lock(ann)
            if target is None:
                v = emit(accs[0], (
                    f"'{model.name}.{attr}' declares guarded-by({ann}) "
                    f"but '{ann}' is not a lock/condition attribute of "
                    f"{model.name}"
                ))
                if v:
                    yield v
                continue
            for a in accs:
                if target not in a.locks_held:
                    word = "write" if a.is_write else "read"
                    v = emit(a, (
                        f"bare {word} of '{model.name}.{attr}' — "
                        f"declared guarded-by({ann}); hold "
                        f"self.{target} for every access"
                    ))
                    if v:
                        yield v
            continue
        guard = model.inferred_guard(attr)
        if guard is not None:
            for a in accs:
                if guard not in a.locks_held:
                    word = "write" if a.is_write else "read"
                    v = emit(a, (
                        f"bare {word} of '{model.name}.{attr}', which "
                        f"is written under self.{guard} elsewhere — "
                        "hold the lock here too, or declare the "
                        "discipline with '# photon: guarded-by(...)'"
                    ))
                    if v:
                        yield v
        elif attr in shared and any(a.is_write for a in accs):
            for a in accs:
                v = emit(a, (
                    f"'{model.name}.{attr}' crosses the thread "
                    f"boundary (thread entry {sorted(model.thread_targets)}) "
                    "with no guard anywhere — protect it with a lock "
                    "or declare '# photon: guarded-by(atomic)' if it "
                    "is a single-writer published reference"
                ))
                if v:
                    yield v


def _lock_expected_callsites(model: ClassModel) -> Iterator[Violation]:
    """A method annotated guarded-by(<lock>) on its def line is a
    caller-holds-the-lock helper: every self-call must prove it."""
    if not model.lock_expected:
        return
    for mname, sc in model._scanners.items():
        if sc.in_init:
            continue
        for node, callee, held in sc.self_calls:
            need = model.lock_expected.get(callee)
            if need is not None and need not in held:
                yield model.ctx.violation(RULE, node, (
                    f"'{model.name}.{callee}' is declared "
                    f"guarded-by({need}) on its def line but this call "
                    f"site does not hold self.{need} — acquire the "
                    "lock around the call (the helper body is analyzed "
                    "as if the lock were held)"
                ))


def _check(pkg: PackageContext) -> Iterator[Violation]:
    for model in pkg.all_classes():
        if not model.concurrent:
            continue
        yield from _class_violations(model)
        yield from _lock_expected_callsites(model)
    for esc in pkg.thread_escapes:
        ctx = pkg.ctx(esc.path)
        if ctx is not None:
            yield ctx.violation(RULE, esc.node, esc.message)


RULE = register_package(
    PackageRule(
        id="PL008",
        slug="unguarded-shared-state",
        doc="every access to a lock-guarded / thread-shared attribute "
            "holds its declared (or inferred) guard",
        check=_check,
    )
)
