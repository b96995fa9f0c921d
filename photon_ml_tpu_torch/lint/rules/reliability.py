"""PL006 reliability-hygiene: artifact writes go through the atomic
write-rename helpers, and swallowed IO failures route through the retry
layer.

Round 11's reliability layer makes two guarantees the rest of the
package must not quietly undermine:

1. **No torn artifacts.** Any ``open(path, "w"/"wb")`` that writes an
   artifact must publish it atomically — via
   ``reliability.artifacts.atomic_writer``/``atomic_write_json`` or an
   explicit same-directory temp + ``os.replace``/``os.rename`` in the
   same scope. A killed process must leave the old file or the new one,
   never a prefix. (Streaming spill writers that append fixed-size
   records behind the ``spill_write`` seam are the grandfathered
   exception — they are progress-manifested, not rename-published.)

2. **No silently swallowed IO failures.** An ``except`` arm that
   catches OSError/IOError (or blanket ``Exception``) around IO work
   and does NOTHING (bare ``pass``/``continue``) hides exactly the
   failures the retry layer exists to handle and account. Route the
   operation through ``reliability.retry.io_call`` (or at minimum
   log/raise). ``__del__``/``close`` teardown scopes are exempt —
   best-effort cleanup is their contract.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from photon_ml_tpu_torch.lint.core import (
    FileContext,
    Rule,
    Violation,
    attr_root,
    call_name,
    register,
)

_ATOMIC_HELPERS = {
    "atomic_writer",
    "atomic_write_json",
    "atomic_write_bytes",
    "atomic_write_text",
}
_IO_CALLEES = {
    "open", "read", "write", "load", "save", "savez", "memmap",
    "rename", "replace", "remove", "unlink", "rmtree", "makedirs",
    "flush", "truncate",
}
_TEARDOWN_SCOPES = {"__del__", "close", "_sweep_spill_dirs"}


def _write_mode(node: ast.Call) -> Optional[str]:
    """The literal write mode of an ``open`` call, or None."""
    mode = None
    if len(node.args) >= 2:
        mode = node.args[1]
    for kw in node.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        if mode.value.startswith(("w", "x", "a")) and "+" not in mode.value:
            return mode.value
    return None


def _scope_has_atomic_publish(ctx: FileContext, scope: ast.AST) -> bool:
    """Atomic helper used, or an explicit os.replace/os.rename in scope
    (NOT str.replace — the root must be the os module)."""
    for node in ctx.walk_scope(scope):
        if isinstance(node, ast.Call):
            name = call_name(node)
            if name in _ATOMIC_HELPERS:
                return True
            if name in ("replace", "rename"):
                root = attr_root(node.func)
                if root is not None and root.id == "os":
                    return True
        elif isinstance(node, ast.Name) and node.id in _ATOMIC_HELPERS:
            return True
    return False


def _check_atomic_writes(ctx: FileContext) -> Iterator[Violation]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or call_name(node) != "open":
            continue
        # plain builtin open only (os.fdopen of an atomic_writer tmp fd
        # is the helper's own implementation)
        if not isinstance(node.func, ast.Name):
            continue
        mode = _write_mode(node)
        if mode is None or mode.startswith("a"):
            continue  # appends are the spill-writer protocol, seam-gated
        scope = ctx.scope_of(node)
        if _scope_has_atomic_publish(ctx, scope):
            continue
        yield ctx.violation(
            RULE, node,
            f"open(..., {mode!r}) publishes an artifact non-atomically: "
            "a crash mid-write leaves a torn file the next stage (or a "
            "resumed run) trusts — write through "
            "reliability.artifacts.atomic_writer/atomic_write_json, or "
            "temp + os.replace in this scope",
        )


def _handler_swallows(handler: ast.ExceptHandler) -> bool:
    """Handler body is ONLY pass/continue (no logging, no raise, no
    fallback work) — the silent-swallow shape."""
    return all(
        isinstance(stmt, (ast.Pass, ast.Continue)) for stmt in handler.body
    )


def _catches_io(handler: ast.ExceptHandler) -> bool:
    names = []
    t = handler.type
    if t is None:
        return True  # bare except
    for node in [t] + (list(t.elts) if isinstance(t, ast.Tuple) else []):
        if isinstance(node, ast.Name):
            names.append(node.id)
        elif isinstance(node, ast.Attribute):
            names.append(node.attr)
    return bool(
        set(names) & {"OSError", "IOError", "EnvironmentError", "Exception"}
    )


def _try_does_io(ctx: FileContext, node: ast.Try) -> bool:
    for stmt in node.body:
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Call) and call_name(sub) in _IO_CALLEES:
                return True
    return False


def _check_swallowed_io(ctx: FileContext) -> Iterator[Violation]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Try):
            continue
        scope = ctx.scope_of(node)
        scope_name = getattr(scope, "name", "")
        if scope_name in _TEARDOWN_SCOPES:
            continue  # best-effort cleanup is the teardown contract
        if not _try_does_io(ctx, node):
            continue
        if ctx.scope_calls(scope, {"io_call"}):
            continue  # already routed through the retry layer
        for handler in node.handlers:
            if _catches_io(handler) and _handler_swallows(handler):
                yield ctx.violation(
                    RULE, handler,
                    "IO failure swallowed (except-and-pass around IO "
                    "work): the retry layer exists so transient errors "
                    "back off and persistent ones are ACCOUNTED — route "
                    "through reliability.retry.io_call, or log/re-raise",
                )


def _check(ctx: FileContext) -> Iterator[Violation]:
    yield from _check_atomic_writes(ctx)
    yield from _check_swallowed_io(ctx)


RULE = register(
    Rule(
        id="PL006",
        slug="reliability-hygiene",
        doc="artifact writes publish atomically (atomic_writer / temp + "
            "os.replace); IO failures are never silently swallowed "
            "outside teardown",
        check=_check,
    )
)
