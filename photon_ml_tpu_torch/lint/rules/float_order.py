"""PL017 float-accumulation-order: host-side ``sum()`` /
``math.fsum`` / ``np.sum`` over an unordered collection. Float
addition is not associative, so the result's low bits follow the
iteration order — which for sets and listdir results follows
``PYTHONHASHSEED`` or the filesystem. Any bitwise-gated value fed by
such a sum (the router's f32 re-sum, conservation-ledger joins, gate
verdicts) then flaps between runs. The contract: accumulate in a
declared canonical order — ``sum(sorted(xs))`` — or keep the
collection ordered end to end.
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
        for node, msg in determinism.file_model(ctx).pl017:
            yield ctx.violation(RULE, node, msg)


RULE = register_package(
    PackageRule(
        id="PL017",
        slug="float-accumulation-order",
        doc="host-side sum()/fsum/np.sum over unordered collections "
            "must iterate a declared canonical order",
        check=_check,
        group="determinism",
    )
)
