"""PL005 undrained-io: every ``submit_io`` scope reaches a ``drain_io``.

``submit_io`` queues artifact writes (checkpoints, metrics, score
parts) on the overlap IO worker; nothing guarantees they hit disk until
``drain_io`` — the barrier before preemption stop, restore, or process
exit. A scope that submits and never drains can exit with writes still
queued: silently truncated artifacts. A function that hands the drain
responsibility to its caller (the driver ``preprocess``/``run`` split)
documents it with ``# photon: allow(undrained-io)`` at the submit site.
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


def _check(ctx: FileContext) -> Iterator[Violation]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if call_name(node) != "submit_io":
            continue
        scope = ctx.scope_of(node)
        if ctx.scope_calls(scope, {"drain_io"}):
            continue
        yield ctx.violation(
            RULE, node,
            "submit_io with no reachable drain_io in this scope: queued "
            "artifact writes may still be in flight at exit — call "
            "overlap.drain_io() before this scope returns, or allow() "
            "the site if a caller owns the barrier",
        )


RULE = register(
    Rule(
        id="PL005",
        slug="undrained-io",
        doc="submit_io scopes must reach drain_io (or hand the barrier "
            "to a documented caller)",
        check=_check,
    )
)
