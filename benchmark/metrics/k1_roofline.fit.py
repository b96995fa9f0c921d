"""K1's share of its roofline in the GAME fit's fixed effect
(``ops/kernels/bilinear_pass.py``, ``ops/csrc/bilinear_pass.cu``)."""

from readers import roofline


def read(record):
    return roofline(record, "bilinear_pass_kernel")
