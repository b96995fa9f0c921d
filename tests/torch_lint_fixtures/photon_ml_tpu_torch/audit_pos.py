"""Seam-audit positive (torch): an allow(hidden-host-sync) in package-path
code whose scope never touches the seam — the readback routes around the
counter, so the allow itself is a violation (and unsuppressable)."""


def rogue_allowed_fetch(t):
    return t.cpu()  # photon: allow(hidden-host-sync)
