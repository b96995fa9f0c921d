"""photon-lint for the port: AST-based static checks for the PyTorch hot
path (a copy of ``photon_ml_tpu/lint/``, adapted; stdlib only: no torch,
no jax, nothing of the JAX package).

Rules (see ``photon_ml_tpu_torch/lint/rules/``):

==========  ======================  ===========================================
id          slug                    protects
==========  ======================  ===========================================
``PL001``   hidden-host-sync        every device->host sync (``.cpu()``,
                                    ``.item()``, ``.tolist()``, ``.numpy()``,
                                    casts of a tensor) goes through the counted
                                    ``overlap.device_get`` / ``fetch_all``
                                    seam; allowed sites must feed it
``PL004``   spill-hygiene           scratch dirs under ``io/`` / GAME streaming
                                    register for the atexit sweep
``PL005``   undrained-io            ``submit_io`` scopes reach a ``drain_io``
``PL006``   reliability-hygiene     artifact writes publish atomically; IO
                                    failures are never silently swallowed
``PL007``   request-path-hygiene    no untimed waits in ``serving/``
``PL008``   unguarded-shared-state  every shared-attr access holds its
                                    declared/inferred guard (whole-package
                                    pass; ``# photon: guarded-by(...)``)
``PL009``   lock-order-inversion    acyclic lock-acquisition order across
                                    modules — NEVER baseline-able
``PL010``   atomicity-hygiene       no stale check-then-act across a lock
                                    release; no callbacks/blocking/foreign
                                    locks inside Condition-backed sections
``PL015``   unordered-iteration-    set/listdir/glob iteration order never
            to-artifact             reaches a serialization or digest sink
                                    without ``sorted()``
``PL016``   ambient-entropy-in-     clocks/pids/uuids/``hash()`` never reach
            artifact                signatures, manifests, cache keys or wire
                                    payloads undeclared
                                    (``# photon: entropy(<reason>)``) — NEVER
                                    baseline-able
``PL017``   float-accumulation-     host-side ``sum()``/``fsum``/``np.sum``
            order                   over unordered collections iterates a
                                    declared canonical order
``PL018``   wire-contract-          every ``MSG_*`` type has encoder, decoder,
            completeness            dispatch and fuzz-corpus entry
                                    (``tests/test_torch_wire.py``); every
                                    ``WireError`` kind a frontend mapping —
                                    NEVER baseline-able
==========  ======================  ===========================================

PL001 is the reference's rule with its taint taken from torch: a value is
a tensor when a parameter is annotated ``Tensor`` or a name is assigned
from a ``torch.*`` call or a tensor method. PL002-PL003 (recompile
hazards, tracer leaks: ``jax.jit``) and PL011-PL014 (``shard_map``
programs, with the reference's ``spmd.py`` and ``sharding_contracts.py``)
are not ported. PL008-PL010 are the concurrency pass and PL015-PL018 the
determinism pass (``lint/determinism.py``); opt out per invocation with
``--no-concurrency`` / ``--no-determinism``.

Usage::

    python -m photon_ml_tpu_torch.lint                  # photon_ml_tpu_torch/
    python -m photon_ml_tpu_torch.lint --json photon_ml_tpu_torch

Suppress a single line with ``# photon: allow(<rule>)`` (id or slug);
grandfathered sites live in the checked-in
``.photon-lint-torch-baseline.json`` (regenerate with
``--write-baseline``). ``tests/test_torch_lint_clean.py`` runs the
analyzer over the whole port under tier-1.
"""

from photon_ml_tpu_torch.lint.core import (
    FileContext,
    PackageContext,
    PackageRule,
    PACKAGE_RULES,
    Report,
    Rule,
    RULES,
    Violation,
    all_rules,
    analyze_paths,
    analyze_source,
    iter_python_files,
    register,
    register_package,
)
from photon_ml_tpu_torch.lint.baseline import (
    BaselineRefused,
    apply_baseline,
    baseline_key,
    load_baseline,
    write_baseline,
)

__all__ = [
    "FileContext",
    "PackageContext",
    "PackageRule",
    "PACKAGE_RULES",
    "Report",
    "Rule",
    "RULES",
    "Violation",
    "all_rules",
    "analyze_paths",
    "analyze_source",
    "iter_python_files",
    "register",
    "register_package",
    "BaselineRefused",
    "apply_baseline",
    "baseline_key",
    "load_baseline",
    "write_baseline",
]
