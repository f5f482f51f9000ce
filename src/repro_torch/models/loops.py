"""The loops that mirror the reference's ``lax.scan``s: the layer cycles,
the microbatches, Mamba's chunks, sLSTM's segments and steps, mLSTM's
chunks and steps.

:func:`trips` runs ``body`` once a trip, as a Python loop: eager dispatch
unrolls what the reference's HLO holds once as a ``while`` body. A cost
model may install a counted loop in its place (:func:`counting`:
``repro_torch.launch.op_cost.counted_loops``, which only the dry run turns
on) that runs a few trips and charges the others, as the reference's HLO
walker multiplies a ``while`` body by its trip count. Without it — every
real run — :func:`trips` is the plain loop.
"""

from __future__ import annotations

from contextlib import contextmanager

# the installed counted loop: fn(body, box, n, params) -> (carry, ys), or None
_COUNTED: list = [None]


def trips(body, box: list, n: int, params=None):
    """``for i in range(n): carry, y = body(carry, i)`` from the carry that
    ``box``, a one-element list, hands over (it is emptied, so that no
    reference to the first carry outlives the trip that consumes it, as in
    a loop that rebinds its variable); returns the last carry and the list
    of the ``y``s. ``body`` takes the carry (a tensor or a tuple or list of
    them) and the trip's index, which it may use only to select the trip's
    slice of a shared input or its own parameters; ``params``, where given,
    is ``params(i)``: trip i's own parameters (a cycle's layers), which a
    counted loop checks alike and gives gradients."""
    counted = _COUNTED[0]
    if counted is not None:
        return counted(body, box, n, params)
    carry = box.pop()
    ys = []
    for i in range(n):
        carry, y = body(carry, i)
        ys.append(y)
    return carry, ys


@contextmanager
def counting(fn):
    """Run the block with ``fn`` in place of :func:`trips`' loop."""
    prev = _COUNTED[0]
    _COUNTED[0] = fn
    try:
        yield
    finally:
        _COUNTED[0] = prev
