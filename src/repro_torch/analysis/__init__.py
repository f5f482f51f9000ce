"""Checks and measurements of the port.

``contracts``
    Profile-based certifier: zero ``torch.distributed`` collectives over a
    chunk of every engine × sampler, the ``(V, d)`` tables updated in
    place, and the ``@zipf50k`` planner traffic against the committed
    bench baseline.
``lint_rules``
    Repo-specific AST lint (RL001–RL004) over ``src/repro_torch``.
``vmem``
    Shared memory a CTA of each engine's kernels against the card's
    budget, and the step's device memory; held to ``cudaFuncGetAttributes``
    on the card.
``dma_model``
    Model checker of the launches' phase order (K2/K4a, K5/K6), the apply
    items and the block planner's hazards; the card's ``%globaltimer``
    timeline held to it.
``workloads``
    Reference workloads shared by the checks and measurements (the
    ``@zipf50k`` kernel shape).

``python -m repro_torch.analysis`` runs ``dma_model``, ``contracts``,
``vmem`` and ``lint``. The
kernel studies (``pair_conflicts``, ``kernel_variants``,
``block_step_variants``, ``chain_phases``) run standalone.
"""

import importlib

__all__ = ["contracts", "dma_model", "lint_rules", "vmem", "workloads"]


def __getattr__(name):
    # the reference's submodule names, imported on first use
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
