"""K2 launches a grid fit (``ops/kernels/grid_bilinear_pass.py``
``launches``, counted where the kernel launches, on the card), the mean
over the window: two a bank evaluation, line-search trials included, so
it tells a grid that did more work from one that ran slower."""

from readers import layer


def read(record):
    return layer(record, "k2_passes")
