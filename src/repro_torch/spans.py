"""Named spans of the port's host work, for ``torch.profiler`` traces.

``span(name)`` is a ``torch.profiler.record_function`` annotation while a
profiler is on and a shared do-nothing context otherwise, so a span costs
one C call when no profiler runs. The profiler's trace is the only store:
the spans land on the clock of the CUDA activity it records, so each idle
stretch of the card can be matched to the span the host was in.

Spans (each name starts with ``repro_torch.``):

* ``train_loop`` — ``core/driver.py``'s training loop;
* ``epoch`` — one chunk of ``make_worker_epoch``'s epoch function, with
  ``epoch.keys`` (the step keys and their seeds), ``epoch.stage`` (the ids'
  copy and step-major layout) and ``epoch.bounds`` (the ids' range check,
  the chunk's one host sync) inside it; the step loop is its self time;
* ``step.draw`` — an engine's negative draw outside the launch (``dense``,
  ``sparse``, ``rowgrad``), ``step.update`` — the call that updates the
  tables, ``step.loss`` — ``sgns.worker_mean``;
* ``merge`` — ``AlirMerger.merge``, with ``merge.init`` (the PCA or random
  init), one ``merge.round`` a round of ALiR that runs (its convergence
  test, a host sync, closes it) and ``merge.maps`` (the per-sub-model maps).
"""

from __future__ import annotations

import contextlib

import torch

_NULL = contextlib.nullcontext()


def span(name: str):
    """A context manager marking ``name`` in the trace of a running
    profiler; the shared null context when none runs."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL
