"""Seconds a GAME fit spends in the fixed-effect coordinate's updates
(``game/coordinate.py`` ``FixedEffectCoordinate``), each timed between two
synchronisations by the benchmark's own wrapper."""

from readers import layer


def read(record):
    return layer(record, "fe_update")
