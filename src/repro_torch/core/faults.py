"""Fault-plane seam.

`repro.core.faults` injects drops, duplicates, delays and dead owners into
every routed phase and AM dispatch. The port has not ported it yet, so the
window and the AM engine ask this seam for the plan in scope and always
get None: the fault-free engine.
"""
from __future__ import annotations


def active_plane():
    """The fault plan in scope; None until the fault plane is ported."""
    return None
