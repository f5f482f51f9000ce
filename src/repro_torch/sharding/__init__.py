"""Execution across processes: the LLM sharding rules and the activation
constraints (:mod:`~repro_torch.sharding.rules`,
:mod:`~repro_torch.sharding.ctx`), and the merge phase's one collective
(:mod:`repro_torch.sharding.merge`)."""

from repro_torch.sharding.rules import (
    param_spec, tree_param_specs, data_spec, cache_spec,
    tree_data_specs, tree_cache_specs, with_sharding, batch_axes,
)

__all__ = [
    "param_spec", "tree_param_specs", "data_spec", "cache_spec",
    "tree_data_specs", "tree_cache_specs", "with_sharding", "batch_axes",
]
