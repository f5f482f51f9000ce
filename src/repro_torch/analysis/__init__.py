"""Checks and measurements of the port.

``contracts``
    Profile-based certifier: zero ``torch.distributed`` collectives over a
    chunk of every engine × sampler, the ``(V, d)`` tables updated in
    place, and the ``@zipf50k`` planner traffic against the committed
    bench baseline.
``lint_rules``
    Repo-specific AST lint (RL001–RL004) over ``src/repro_torch``.
``workloads``
    Reference workloads shared by the checks and measurements (the
    ``@zipf50k`` kernel shape).

``python -m repro_torch.analysis`` runs ``contracts`` and ``lint``. The
kernel studies (``pair_conflicts``, ``kernel_variants``,
``block_step_variants``, ``chain_phases``) run standalone.
"""
