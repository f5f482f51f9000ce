"""Update engines — the per-step SGNS compute as one swappable object.

The counterpart of ``repro.core.engine``. An :class:`UpdateEngine` owns
everything a training step does between receiving a ``(centers,
contexts)`` micro-batch and returning updated parameters: the negative
draw (and the noise-table layout it consumes), the row gradients, and
the parameter apply. The port's steps are **worker-batched**: one call
covers all n sub-models, with params ``(n, V, d)``, centers/contexts
``(n, B)`` and seeds ``(n, 2)``.

Registry (``get_engine``):

``fused``
    The whole step in one kernel call (``kernels/sgns_fused.py``, K2):
    negatives drawn in-kernel from the alias tables by the counter hash,
    forward, row gradients and the deterministic accumulating apply,
    tables updated in place. The counterpart of ``pallas_fused``.

:data:`REFERENCE_ENGINE` names each engine's counterpart in the JAX
package, for tests and benchmark rows.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core import sgns
from repro_torch.core.sgns import SGNSConfig


@dataclass(frozen=True)
class UpdateEngine:
    """Base engine: step construction for one noise-table layout."""

    name = "base"
    #: Noise-table layout this engine's steps consume — pass to
    #: ``build_noise_table(kind=...)``.
    table_kind = "alias"

    def make_step(self, cfg: SGNSConfig, total_steps: int):
        """Returns ``step(params, centers, contexts, neg_table, seeds,
        step_idx) -> (params, mean_loss (n,))``."""
        raise NotImplementedError

    def validate(self, *, vocab_size: int | None = None) -> None:
        """Check dials that only make sense against a model shape."""

    def describe(self) -> str:
        return f"{self.name}:{self.table_kind}"


@dataclass(frozen=True)
class FusedEngine(UpdateEngine):
    """One kernel call per step for all workers: in-kernel alias
    negative sampling + forward + row grads + apply."""

    name = "fused"

    def make_step(self, cfg: SGNSConfig, total_steps: int):
        from repro_torch.kernels.sgns_fused import sgns_fused_step

        def step(params, centers, contexts, neg_table, seeds, step_idx):
            lr = sgns.linear_lr(step_idx, total_steps, cfg)
            params, loss, _ = sgns_fused_step(
                params, centers, contexts, neg_table, seeds, float(lr),
                negatives=cfg.negatives)
            return params, loss.mean(dim=1)

        return step


ENGINES: dict[str, type[UpdateEngine]] = {
    "fused": FusedEngine,
}
ENGINE_NAMES = tuple(ENGINES)

#: The JAX package's engine each port engine is held against.
REFERENCE_ENGINE = {"fused": "pallas_fused"}


def get_engine(spec: str | UpdateEngine = "fused") -> UpdateEngine:
    """Resolve an engine spec: an instance (returned as-is) or a name."""
    if isinstance(spec, UpdateEngine):
        return spec
    if spec not in ENGINES:
        raise ValueError(
            f"unknown update engine {spec!r}; expected one of {sorted(ENGINES)}")
    return ENGINES[spec]()
