"""PL010 atomicity-hygiene: critical sections stay small, private, and
actually atomic.

Three failure shapes the serving/registry thread plane is prone to,
each one a bug the chaos runs can only catch probabilistically:

- **check-then-act across a lock release.** A guarded field is read
  under the lock, the lock is released (slow work happens), then the
  field is written under the lock again in the same method — the
  decision is stale by the time it lands (the watcher's
  read-live/stage/write-live rollback shape). Flagged unless some
  OUTER lock is provably held across both sections (that is the
  sanctioned serialize-the-whole-protocol fix).
- **foreign work under a condition-backed lock.** While holding a lock
  that backs a ``Condition`` (the batcher's queue lock — the one
  submitters and the dispatcher park on), calling a user callback
  (``on_*``/``*_hook``/``*_handler``/``*_provider``), a known-blocking
  primitive (``sendall``/``recv``/``sleep``...), or another package
  component's lock-taking method stretches everyone's wakeup latency
  and invites reentrancy deadlocks. Move the call outside the critical
  section; capture what it needs under the lock.
- **notify without the condition's lock.** ``cond.notify()`` /
  ``notify_all()`` without holding the condition's backing lock raises
  at runtime at best and loses wakeups at worst (the missed-wakeup
  hang the drain tests chase).
"""

from __future__ import annotations

import ast
from typing import Iterator, Set, Tuple

from photon_ml_tpu_torch.lint.core import (
    _BLOCKING_TAILS,
    _CALLBACK_NAME_RE,
    _ONE_HOP_STOPLIST,
    ClassModel,
    PackageContext,
    PackageRule,
    Violation,
    call_name,
    register_package,
)


def _check_then_act(model: ClassModel) -> Iterator[Violation]:
    """Read-under-lock then write-under-same-lock-later with the lock
    released in between (and no outer lock held across)."""
    by_method: dict = {}
    for attr, accs in model.accesses.items():
        if attr in model.lock_names() | model.safe_attrs:
            continue
        for a in accs:
            if not a.in_init and a.locks_held:
                by_method.setdefault((a.method, attr), []).append(a)
    emitted: Set[Tuple[int, str]] = set()
    for (method, attr), accs in sorted(by_method.items()):
        accs.sort(key=lambda a: getattr(a.node, "lineno", 0))
        for i, first in enumerate(accs):
            if first.is_write:
                continue
            for later in accs[i + 1:]:
                if not later.is_write:
                    continue
                shared = first.locks_held & later.locks_held
                if not shared:
                    continue
                # a (lock, acquisition-site) pair present at BOTH
                # accesses means that lock was held continuously
                if first.lock_acqs & later.lock_acqs:
                    continue
                line = getattr(later.node, "lineno", 0)
                key = (line, attr)
                if key in emitted:
                    continue
                emitted.add(key)
                lk = sorted(shared)[0]
                yield model.ctx.violation(
                    RULE, later.node,
                    f"check-then-act across a lock release: "
                    f"'{model.name}.{attr}' was read under "
                    f"self.{lk} at line "
                    f"{getattr(first.node, 'lineno', '?')}, the lock "
                    "was released, and this write re-acquires it — "
                    "the decision is stale; hold one lock across the "
                    "whole protocol or re-check under the lock here",
                )


def _under_lock_calls(
    model: ClassModel, pkg: PackageContext,
) -> Iterator[Violation]:
    index = pkg._method_lock_index()
    emitted: Set[int] = set()
    for mname, sc in model._scanners.items():
        for call, held in sc.calls_under_lock:
            hot = held & model.cond_backed
            if not hot:
                continue
            line = getattr(call, "lineno", 0)
            if line in emitted:
                continue
            name = call_name(call)
            func = call.func
            lk = sorted(hot)[0]
            if isinstance(func, ast.Attribute) and _CALLBACK_NAME_RE.match(
                name
            ):
                emitted.add(line)
                yield model.ctx.violation(
                    RULE, call,
                    f"user callback '{name}' invoked while holding "
                    f"self.{lk} (a Condition-backed lock): arbitrary "
                    "code inside the critical section stalls every "
                    "parked waiter — capture under the lock, call "
                    "after release",
                )
                continue
            if name in _BLOCKING_TAILS:
                emitted.add(line)
                yield model.ctx.violation(
                    RULE, call,
                    f"blocking call '{name}' while holding self.{lk} "
                    "(a Condition-backed lock) — waiters park behind "
                    "real IO/sleep time; move it outside the critical "
                    "section",
                )
                continue
            if (
                isinstance(func, ast.Attribute)
                and not isinstance(func.value, ast.Name)
                or (
                    isinstance(func, ast.Attribute)
                    and isinstance(func.value, ast.Name)
                    and func.value.id != "self"
                )
            ):
                if name not in _ONE_HOP_STOPLIST and index.get(name):
                    targets = sorted(
                        {f"{t[1]}.{t[2]}" for t in index[name]}
                    )
                    emitted.add(line)
                    yield model.ctx.violation(
                        RULE, call,
                        f"'{name}' (which acquires {', '.join(targets)}) "
                        f"called while holding self.{lk}, a Condition-"
                        "backed lock — foreign critical sections do "
                        "not belong inside the wait lock; record the "
                        "fact under the lock, call after release",
                    )


def _notify_discipline(model: ClassModel) -> Iterator[Violation]:
    for mname, sc in model._scanners.items():
        for call, cond, held in sc.notifies:
            backing = model.cond_alias.get(cond, cond)
            if backing not in held:
                yield model.ctx.violation(
                    RULE, call,
                    f"{call_name(call)}() on self.{cond} without "
                    f"holding its lock (self.{backing}) — notify "
                    "outside the condition's lock races the waiter's "
                    "predicate re-check and loses wakeups",
                )


def _check(pkg: PackageContext) -> Iterator[Violation]:
    for model in pkg.all_classes():
        if not model.concurrent:
            continue
        yield from _check_then_act(model)
        yield from _under_lock_calls(model, pkg)
        yield from _notify_discipline(model)


RULE = register_package(
    PackageRule(
        id="PL010",
        slug="atomicity-hygiene",
        doc="no stale check-then-act across a lock release, no "
            "callbacks/blocking/foreign locks inside a Condition-backed "
            "critical section, notify only under the condition's lock",
        check=_check,
    )
)
