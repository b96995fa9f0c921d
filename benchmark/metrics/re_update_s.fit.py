"""Seconds a GAME fit spends in the random-effect coordinate's updates
(``game/coordinate.py`` ``RandomEffectCoordinate`` over
``game/random_effect.py``), each timed between two synchronisations."""

from readers import layer


def read(record):
    return layer(record, "re_update")
