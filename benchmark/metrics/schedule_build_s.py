"""Host seconds of the schedule build in set-up (``ops/tiled_sparse.py``
``build_tiled_batch`` / ``ensure_tiled``: the native counting sort of both
passes and their upload), on the host clock around the call."""

from readers import layer


def read(record):
    return layer(record, "schedule_build_s")
