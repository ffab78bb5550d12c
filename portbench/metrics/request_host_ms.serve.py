"""Milliseconds of a request the card is not busy: each
``portbench.request`` span's wall time minus the device-busy time inside
it (union of intervals), averaged over the traced window's requests."""
from portbench.metrics._common import request_host_ms


def read(run):
    return request_host_ms(run)
