"""Rule modules — importing this package registers every rule the port
has: PL001 for torch, the framework-free per-file rules PL004-PL007, the
concurrency pass PL008-PL010 and the determinism pass PL015-PL018.
PL002-PL003 and PL011-PL014 check jax programs and are not ported."""

from photon_ml_tpu_torch.lint.rules import (  # noqa: F401
    artifact_order,
    atomicity,
    entropy,
    float_order,
    host_sync,
    io_drain,
    lock_order,
    reliability,
    request_path,
    shared_state,
    spill,
    wire_contract,
)
