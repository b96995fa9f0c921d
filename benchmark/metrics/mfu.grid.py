"""The grid fits' required work at the chip's peak over the window, percent."""

from readers import mfu as read  # noqa: F401
