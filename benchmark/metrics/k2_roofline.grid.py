"""K2's share of its roofline (``ops/kernels/grid_bilinear_pass.py``,
``ops/csrc/grid_bilinear_pass.cu``): every launch over the bank of the
grid's members, matched by kernel name in the trace."""

from readers import roofline


def read(record):
    return roofline(record, "grid_bilinear_pass_kernel", record.shapes["members"])
