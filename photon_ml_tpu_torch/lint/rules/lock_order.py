"""PL009 lock-order-inversion: the cross-module lock-acquisition graph
is acyclic.

The serving/registry thread plane nests locks on purpose — a dispatch
holds the donation lock while the generation manager flips under its
own, the batcher's queue lock wraps admission bookkeeping — and that is
fine exactly as long as every thread acquires them in one global order.
A cycle in the acquisition-order graph is a deadlock with a schedule
attached: thread A holds L1 wanting L2 while thread B holds L2 wanting
L1, and the whole request path stops beating.

The graph (built by the package pass in ``lint/core.py``):

- **nodes** are lock identities — ``(class, attr)`` for
  ``self._lock``-style attributes (Conditions alias their backing
  lock) and ``(module, global)`` for module-level locks;
- **edges** come from syntactic nesting (``with self.a:`` containing
  ``with self.b:``) and from ONE-HOP calls: invoking a package method
  that itself acquires a lock while holding one. One-hop resolution is
  by method name with a stoplist of generic names (``get``/``put``/
  ``append``...) so dict traffic does not wire the graph to noise.

Every cycle is reported at each participating edge site. Lock
inversions are NEVER baseline-able (``--write-baseline`` refuses, and
``load_baseline`` rejects hand-edited PL009 entries): a potential
deadlock does not get grandfathered, it gets reordered.

Known honest limitation: a lock smuggled through a constructor alias
(``MicroBatcher(swap_lock=model.dispatch_lock)``) is invisible to the
static graph — that is the interleaving harness's job
(``photon_ml_tpu_torch/testing/interleave.py``).
"""

from __future__ import annotations

from typing import Iterator

from photon_ml_tpu_torch.lint.core import (
    PackageContext,
    PackageRule,
    Violation,
    register_package,
)


def _lock_name(node: tuple) -> str:
    if node[0] == "class":
        return f"{node[1]}.{node[2]}"
    return f"{node[2]} ({node[1]})"


def _check(pkg: PackageContext) -> Iterator[Violation]:
    for cycle in pkg.lock_cycles():
        path = " -> ".join(
            [_lock_name(e.src) for e in cycle] + [_lock_name(cycle[0].src)]
        )
        for edge in cycle:
            ctx = pkg.ctx(edge.path)
            if ctx is None:
                continue
            yield ctx.violation(
                RULE,
                _Anchor(edge.line),
                f"lock-order inversion cycle [{path}]: this site "
                f"acquires {_lock_name(edge.dst)} while holding "
                f"{_lock_name(edge.src)} ({edge.via}), but another "
                "site acquires them in the reverse order — pick ONE "
                "global order (inversions are never baseline-able)",
            )


class _Anchor:
    """A bare line anchor for violations whose 'node' is a graph edge."""

    def __init__(self, line: int):
        self.lineno = line
        self.col_offset = 0


RULE = register_package(
    PackageRule(
        id="PL009",
        slug="lock-order-inversion",
        doc="the cross-module lock-acquisition-order graph stays "
            "acyclic — a cycle is a deadlock with a schedule attached",
        check=_check,
    )
)
