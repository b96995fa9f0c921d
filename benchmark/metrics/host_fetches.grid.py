"""Host fetches a grid fit makes (``optim.common.host_fetches``, the
optimizers' one counted device-to-host seam), the mean over the window."""

from readers import layer


def read(record):
    return layer(record, "host_fetches")
