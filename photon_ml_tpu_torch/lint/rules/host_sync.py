"""PL001 hidden-host-sync, for torch: every device->host fetch goes
through the counted ``parallel/overlap.py`` seam (``device_get``,
``fetch_all``).

A raw ``.cpu()`` / ``.item()`` / ``.tolist()`` / ``.numpy()`` or a
``float()`` / ``int()`` / ``bool()`` of a CUDA tensor is a synchronous
host round trip: the card's queue drains into a host stall that the
readback counters (``overlap.readback_stats``) cannot see. The rule is
the reference's (``photon_ml_tpu/lint/rules/host_sync.py``) with its
taint taken from torch instead of jax:

- ``.cpu()`` is flagged wherever it is called (only a tensor has it);
- ``.item()``, ``.tolist()``, ``.numpy()`` and the casts only where the
  value provably holds a tensor: a parameter annotated ``Tensor``, or a
  name assigned from a ``torch.*`` call or a tensor method (the core's
  per-scope taint). ``.tolist()`` on a numpy array, or ``.numpy()`` on
  the result of ``.cpu()``, is not flagged: low-noise by construction.

It also keeps the reference's audit of ``# photon: allow(hidden-host-sync)``
sites inside the package: an allowed raw fetch must still be
*accounted* — its enclosing scope has to touch the seam
(``overlap.device_get`` / ``fetch_all``) or the overlap-off serial switch
(``overlap_enabled`` / ``overlap_scope``). An allow comment that routes
around the counter without either is itself a violation, and that audit
violation cannot be suppressed by the comment it audits (only baselined
or fixed).
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from photon_ml_tpu_torch.lint.core import (
    FileContext,
    Rule,
    Violation,
    in_package,
    register,
)

_CASTS = {"float", "int", "bool"}
_TENSOR_SYNCS = {"item", "tolist", "numpy"}
# referencing any of these marks a scope as seam-aware: it either feeds
# the counted readback path or switches on the overlap-off serial path
_SEAM_NAMES = {
    "fetch_all", "overlap_enabled", "overlap_scope", "readback_stats",
}


def _is_overlap_device_get(ctx: FileContext, call: ast.Call) -> bool:
    func = call.func
    if isinstance(func, ast.Attribute) and func.attr == "device_get":
        return ctx.is_overlap_module(func.value)
    if isinstance(func, ast.Name) and func.id == "device_get":
        return "device_get" in ctx.overlap_names
    return False


def _scope_at_line(ctx: FileContext, line: int) -> ast.AST:
    best: Optional[ast.AST] = None
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            end = getattr(node, "end_lineno", node.lineno)
            if node.lineno <= line <= end:
                if best is None or node.lineno > best.lineno:
                    best = node
    return best if best is not None else ctx.tree


def seam_accounted(ctx: FileContext, line: int) -> bool:
    """Is the allow-site at ``line`` accounted: does its enclosing scope
    reference the counted seam or the overlap on/off switch?"""
    scope = _scope_at_line(ctx, line)
    if ctx.scope_calls(scope, _SEAM_NAMES):
        return True
    for node in ctx.walk_scope(scope):
        if isinstance(node, ast.Call) and _is_overlap_device_get(ctx, node):
            return True
    return False


def _check(ctx: FileContext) -> Iterator[Violation]:
    if ctx.path.endswith("parallel/overlap.py"):
        # the seam itself is the one legitimate home of raw fetches
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr == "cpu" and not node.args:
            yield ctx.violation(
                RULE, node,
                ".cpu() copies a tensor to the host outside the counted "
                "overlap.device_get seam — fetch through "
                "photon_ml_tpu_torch.parallel.overlap.device_get (or batch "
                "it via Deferred/fetch_all)",
            )
        elif isinstance(func, ast.Attribute) and func.attr in _TENSOR_SYNCS:
            taint = ctx.torch_taint(ctx.scope_of(node))
            if ctx.expr_tainted(func.value, taint):
                yield ctx.violation(
                    RULE, node,
                    f".{func.attr}() on a tensor forces a device->host copy "
                    "outside the counted seam — fetch through "
                    "overlap.device_get first",
                )
        elif (
            isinstance(func, ast.Name)
            and func.id in _CASTS
            and len(node.args) == 1
            and not node.keywords
        ):
            taint = ctx.torch_taint(ctx.scope_of(node))
            if ctx.expr_tainted(node.args[0], taint):
                yield ctx.violation(
                    RULE, node,
                    f"{func.id}() on a tensor is a synchronous per-scalar "
                    "readback — keep it a device scalar (Deferred) and "
                    "batch the fetch",
                )
    # allow-site audit: seam_ok is recorded for EVERY hidden-host-sync
    # allow site (listed in --json); only package code turns an
    # unaccounted site into a violation — bench/test timing harnesses
    # may legitimately sync without feeding the seam.
    package = in_package(ctx)
    audited = set()
    for site in ctx.allow_sites:
        if not (site.rules & {"PL001", "hidden-host-sync"}):
            continue
        site.seam_ok = seam_accounted(ctx, site.applies_to)
        if site.applies_to in audited:
            continue  # stacked comments on one line: audit it once
        audited.add(site.applies_to)
        if package and not site.seam_ok:
            yield Violation(
                rule=RULE.id, slug=RULE.slug, path=ctx.path,
                line=site.applies_to, col=0,
                message=(
                    "allow(hidden-host-sync) site is unaccounted: "
                    "the enclosing scope neither routes through "
                    "overlap.device_get/fetch_all nor gates on the "
                    "overlap-off serial path (overlap_enabled/"
                    "overlap_scope) — the readback would be "
                    "invisible to the seam counter"
                ),
                snippet=ctx.snippet(site.applies_to),
                suppressable=False,
            )


RULE = register(
    Rule(
        id="PL001",
        slug="hidden-host-sync",
        doc="device->host fetches must route through overlap.device_get",
        check=_check,
    )
)
