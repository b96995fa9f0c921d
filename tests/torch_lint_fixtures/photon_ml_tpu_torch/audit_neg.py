"""Seam-audit negatives (torch): allowed raw fetches that stay accounted —
the scope either gates on the overlap-off serial switch or also feeds the
counted seam."""

from photon_ml_tpu_torch.parallel import overlap
from photon_ml_tpu_torch.parallel.overlap import overlap_enabled


def serial_path_fetch(t):
    if not overlap_enabled():
        return t.cpu()  # photon: allow(hidden-host-sync)
    return overlap.device_get(t)


def counted_alongside(t, other):
    host = overlap.device_get(other)  # the counted fetch
    raw = t.cpu()  # photon: allow(hidden-host-sync)
    return host, raw
