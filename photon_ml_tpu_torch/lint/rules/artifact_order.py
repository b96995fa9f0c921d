"""PL015 unordered-iteration-to-artifact: a ``set``/``frozenset``/
``os.listdir``/``glob`` iteration order reaching a serialization or
digest sink is ``PYTHONHASHSEED``- or filesystem-order-dependent, so
the artifact bytes — and every bitwise gate that compares them
(content signatures, chaos parity, swap/rollback restore) — drift
between runs. The fix is always the same: ``sorted()`` before the
bytes are committed. The taint model lives in
``lint/determinism.py``; this rule just reports its PL015 sites.
"""

from __future__ import annotations

from typing import Iterator

from photon_ml_tpu_torch.lint import determinism
from photon_ml_tpu_torch.lint.core import (
    PackageContext,
    PackageRule,
    Violation,
    register_package,
)


def _check(pkg: PackageContext) -> Iterator[Violation]:
    for path in sorted(pkg.contexts):
        ctx = pkg.contexts[path]
        for node, msg in determinism.file_model(ctx).pl015:
            yield ctx.violation(RULE, node, msg)


RULE = register_package(
    PackageRule(
        id="PL015",
        slug="unordered-iteration-to-artifact",
        doc="set/listdir/glob iteration order must not reach a "
            "serialization or digest sink without sorted()",
        check=_check,
        group="determinism",
    )
)
