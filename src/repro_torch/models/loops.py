"""Python loops of identical trips, which a dry-run trace counts from
three of them.

The recurrent layers' loops (the Mamba scan's time blocks and steps, the
sLSTM's tokens, the mLSTM's chunks) unroll once per trip, so a trace of
a 32k-token prefill would dispatch millions of operations.  Serving runs
every trip: ``trips(n)`` is ``range(n)`` and ``full`` hands its list
back.  While ``launch.roofline`` traces a step it sets ``TRACER``; a loop
of more than three trips then runs three of them: the first, the second
standing for the n - 2 middle ones, and the last.  The tracer counts
each operation of the middle trip n - 2 times, in the forward pass and,
through the autograd nodes the trip made, in the backward pass.
``full(outs, n)`` puts the middle trip's output, detached, in the place
of each trip that did not run, so it takes no gradient.

Every trip of such a loop has the same shapes.  The first and last run
once each because their backward passes differ from the others': the
first starts from the loop's initial state, which may need no gradient,
and the last hands its state to no further trip.  A gradient buffer
that every trip adds to (a tensor each trip reads) or that carries from
trip to trip is then summed once per trip, as in a trace of every trip:
the autograd engine adds an arrival under the node that sends it, and
the middle trip's nodes send theirs n - 2 times.  ``tests/
test_torch_dryrun.py`` holds the count to a trace of every trip.
"""
from __future__ import annotations

from typing import Iterable

TRACER = None   # set by launch.roofline while it traces; None when serving


def trips(n: int, name: str) -> Iterable[int]:
    """The trip indices a loop of ``n`` identical trips runs; ``name``
    says which loop it is in the tracer's record."""
    if TRACER is None or n <= 3:
        return range(n)
    return _three(TRACER, n, name)


def _three(tracer, n: int, name: str):
    yield 0
    with tracer.weighted(n - 2, name, n):
        yield 1
    yield n - 1


def full(outs: list, n: int) -> list:
    """The ``n`` per-trip outputs of a loop that ran ``trips(n)``."""
    if len(outs) == n:
        return outs
    return TRACER.fill(outs, n)
