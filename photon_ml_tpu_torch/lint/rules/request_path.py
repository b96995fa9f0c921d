"""PL007 request-path-hygiene: no unbounded blocking waits in
``photon_ml_tpu_torch/serving/``.

The serving contract is that EVERY request reaches exactly
one terminal outcome in bounded time — shed, deadline-exceeded,
drain-failed or scored — and that the dispatcher's liveness heartbeat
keeps beating even when idle. Both die the moment any thread on the
request path parks on an untimed primitive: an untimed
``Condition.wait()`` is a dispatcher that cannot observe shutdown, an
untimed ``Future.result()`` is a client thread a lost wakeup hangs
forever. Those are exactly the hangs the drain tests chase, so the
analyzer rejects them at review time instead:

- ``<anything>.wait()`` with no ``timeout`` — ``threading.Condition``,
  ``threading.Event``, or any wait-shaped API — must pass a timeout
  (positionally or by keyword) and re-check its predicate in a loop;
- ``<anything>.result()`` with no ``timeout`` — ``concurrent.futures``
  blocks unbounded by default; pass ``timeout=`` (``timeout=0`` inside
  a done-callback, where the future is already terminal).

Scope: files under a ``serving`` package directory (the request path).
Host-side driver/bench code may still block on its own replay futures;
the SERVICE may not. The baseline for this rule is pinned at ZERO
entries by ``tests/test_lint_clean.py`` — new request-path code starts
bounded or does not land.
"""

from __future__ import annotations

import ast
from typing import Iterator

from photon_ml_tpu_torch.lint.core import (
    FileContext,
    Rule,
    Violation,
    call_name,
    register,
)

_BLOCKING = {"wait", "result"}


def _applies(ctx: FileContext) -> bool:
    return "serving" in ctx.path_parts()


def _has_timeout(node: ast.Call) -> bool:
    if node.args:
        return True  # wait(5.0) / result(2) — positional timeout
    return any(kw.arg == "timeout" for kw in node.keywords)


def _check(ctx: FileContext) -> Iterator[Violation]:
    if not _applies(ctx):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        if name not in _BLOCKING:
            continue
        # method form only (cond.wait() / fut.result()); a bare local
        # helper named wait()/result() is not the stdlib primitive
        if not isinstance(node.func, ast.Attribute):
            continue
        if _has_timeout(node):
            continue
        yield ctx.violation(
            RULE, node,
            f".{name}() without a timeout on the request path: an "
            "untimed blocking wait is a future that can hang and a "
            "dispatcher that cannot observe shutdown — pass timeout= "
            "and re-check the predicate in a loop (the drain/heartbeat "
            "contract)",
        )


RULE = register(
    Rule(
        id="PL007",
        slug="request-path-hygiene",
        doc="no untimed Condition.wait()/Future.result() in serving/ — "
            "every request-path wait is bounded",
        check=_check,
    )
)
