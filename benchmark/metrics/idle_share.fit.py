"""Percent of the GAME window in which the device ran nothing."""

from readers import idle_share as read  # noqa: F401
