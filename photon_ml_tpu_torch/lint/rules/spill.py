"""PL004 spill-hygiene: scratch dirs must register for the atexit sweep.

The disk-spill stores (GLM chunk cache, GAME chunk/score/bucket
segments) can hold multi-GB scratch; ``__del__`` is not a cleanup
contract (a driver exception pinning the objective in a traceback
skips finalizers and leaks the scratch). Every spill directory created
under ``io/`` or the GAME streaming layer must go through
``make_spill_dir`` or pair its ``mkdtemp``/``TemporaryDirectory`` with
``register_spill_dir`` in the same scope, so ``_sweep_spill_dirs`` can
reclaim it at interpreter exit.
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

_TMP_FACTORIES = {"mkdtemp", "TemporaryDirectory"}
_REGISTRARS = {"register_spill_dir", "make_spill_dir"}


def _applies(ctx: FileContext) -> bool:
    return "io" in ctx.path_parts() or ctx.path.endswith(
        "game/streaming.py"
    )


def _check(ctx: FileContext) -> Iterator[Violation]:
    if not _applies(ctx):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if call_name(node) not in _TMP_FACTORIES:
            continue
        scope = ctx.scope_of(node)
        if ctx.scope_calls(scope, _REGISTRARS):
            continue
        yield ctx.violation(
            RULE, node,
            f"{call_name(node)} in the spill layer without "
            "register_spill_dir: the scratch dir dodges the atexit "
            "sweep and leaks on driver exceptions — use "
            "io.streaming.make_spill_dir (or register explicitly in "
            "this scope)",
        )


RULE = register(
    Rule(
        id="PL004",
        slug="spill-hygiene",
        doc="spill scratch dirs under io// game streaming register for "
            "the atexit sweep",
        check=_check,
    )
)
