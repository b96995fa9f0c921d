"""PL016 ambient-entropy-in-artifact: wall clocks, pids, hostnames,
``uuid``, unseeded ``random`` and the hash-randomized builtins
``hash()``/``id()`` must not reach content signatures, manifests,
wire payloads, cache keys or RNG seeds undeclared. Legitimate sites
(the tracer's boot nonce, span epochs, live telemetry timestamps)
carry a ``# photon: entropy(<reason>)`` declaration — an enforced
claim, like ``guarded-by`` and ``sharding()``: a reasonless or stale
declaration is itself a violation, and the rule refuses the baseline
(NEVER_BASELINE) because an inherited entropy leak in a signature is
exactly the drift the bitwise gates exist to catch.

Violations are not ``# photon: allow(...)``-suppressable: the only
ways out are deriving the value from content or declaring the
entropy.
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
        model = determinism.file_model(ctx)
        for node, msg in model.pl016:
            yield ctx.violation(RULE, node, msg, suppressable=False)
        for line, msg in model.stale:
            yield Violation(
                rule=RULE.id, slug=RULE.slug, path=ctx.path,
                line=line, col=0, message=msg,
                snippet=ctx.snippet(line), suppressable=False,
            )


RULE = register_package(
    PackageRule(
        id="PL016",
        slug="ambient-entropy-in-artifact",
        doc="clocks/pids/uuids/hash() must not reach signatures, "
            "manifests, cache keys or wire payloads without a "
            "'# photon: entropy(reason)' declaration",
        check=_check,
        group="determinism",
    )
)
