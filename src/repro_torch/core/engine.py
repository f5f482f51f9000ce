"""Update engines — the per-step SGNS compute as one swappable object.

The counterpart of ``repro.core.engine``. An :class:`UpdateEngine` owns
everything a training step does between receiving a ``(centers,
contexts)`` micro-batch and returning updated parameters: the negative
draw (and the noise-table layout it consumes), the row gradients, and
the parameter apply. The port's steps are **worker-batched**: one call
covers all n sub-models, with params ``(n, V, d)`` (updated in place),
centers/contexts ``(n, B)`` and seeds ``(n, 2)``.

Registry (``get_engine``):

``dense``
    Autograd through the gathers; a dense ``(n·V, d)`` gradient. The
    oracle — simple and slow.
``sparse``
    Manual per-row gradients and an accumulating scatter-add, plain
    torch; each row's addends are added in pair order
    (``sgns.ordered_add_``), so a step repeats bit for bit on the card.
``rowgrad``
    ``sparse`` with the row gradients computed by K3
    (``kernels/sgns_update.py``); the draw, the gathers and the scatter
    stay torch. The counterpart of ``pallas``.
``fused``
    The whole step in one kernel launch (``kernels/sgns_fused.py``, K2):
    the draw of the negatives from the alias tables by the counter hash
    (K1's draw, made inside the launch), the sort of each worker's touched
    rows, the forward, the row gradients and the deterministic
    accumulating apply. The counterpart of ``pallas_fused``; the port's
    main-path engine.
``fused_hbm``
    The fused step as a chain of pair blocks, or in word2vec's per-pair
    order (``kernels/sgns_fused_hbm.py``, K4). Fields ``block_pairs`` (a
    shorter tail block covers any remainder) and ``sequential``. On the
    card the chain is one persistent launch a step, the draw and the row
    sort inside it (K4a, shared with K2). The counterpart of
    ``pallas_fused_hbm``.
``fused_pipe``
    The same block chain in one kernel launch a step
    (``kernels/sgns_fused_pipe.py: chain_step``, K5): K1's draw, K4a's two
    stable (block, row) sorts, then one persistent launch that walks every
    worker's blocks with the rows updated in place, each worker's CTAs
    separated by group barriers. No ring and no block planner run on the
    card; ``ring_depth`` (the reference's ring, >= 2) is accepted and
    changes nothing there. Bitwise ``fused_hbm`` at the same
    ``block_pairs``. ``sequential=True`` runs K4b. The counterpart of
    ``pallas_fused_pipe``.
``fused_tiered``
    ``fused_pipe`` with the ``hot_rows`` most frequent rows of each table
    kept in the L2 cache by load and store hints for the step
    (``kernels/sgns_fused_tiered.py``, K6); bitwise ``fused_hbm`` too. The
    counterpart of ``pallas_fused_tiered``.

Engine specs are engine instances or strings, optionally carrying a
sampler: ``"sparse"``, ``"sparse:alias"``, ``"rowgrad:cdf"``. ``dense``,
``sparse`` and ``rowgrad`` draw with the ``jax.random`` samplers of
``data/pairs.py`` (``cdf`` by default, as in the reference); the fused
engines draw with the counter hash from alias tables, so ``"alias"`` is
their only valid sampler. The reference's TPU-only dials (``interpret``,
``block_b``) change no result and are not carried over.

:data:`REFERENCE_ENGINE` names each engine's counterpart in the JAX
package, for tests and benchmark rows. Engines are frozen dataclasses,
so they hash and compare by value.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.core import sgns
from repro_torch.core.sgns import SGNSConfig
from repro_torch.data.pairs import negative_sampler_fn
from repro_torch.spans import span


@dataclass(frozen=True)
class UpdateEngine:
    """Base engine: negative draw + step construction.

    ``sampler`` names the negative draw ("cdf" | "alias") and fixes
    :attr:`table_kind`, the noise-table layout the engine's steps consume
    — ``(n, V)`` CDFs or ``{"prob", "alias"}`` alias tables (see
    ``repro_torch.data.pairs.build_noise_table``)."""

    sampler: str = "cdf"
    name = "base"

    def __post_init__(self):
        negative_sampler_fn(self.sampler)           # rejects unknown names

    @property
    def table_kind(self) -> str:
        """Noise-table layout this engine's steps consume — pass to
        ``build_noise_table(kind=...)``."""
        return self.sampler

    def sample(self, table, seeds, shape: tuple[int, ...]):
        """``(n, *shape)`` negative ids drawn outside a kernel."""
        return negative_sampler_fn(self.sampler)(table, seeds, shape)

    def make_step(self, cfg: SGNSConfig, total_steps: int):
        """Returns ``step(params, centers, contexts, neg_table, seeds,
        step_idx) -> (params, mean_loss (n,))``."""
        raise NotImplementedError

    def validate(self, *, vocab_size: int | None = None, dim: int | None = None,
                 negatives: int | None = None) -> None:
        """Check dials that only make sense against a model shape; with
        ``dim`` and ``negatives``, also that a CTA of each of the step's
        kernels fits the card's shared memory
        (:func:`repro_torch.analysis.vmem.check_vmem_budget`)."""
        if dim is not None and negatives is not None:
            from repro_torch.analysis.vmem import check_vmem_budget

            check_vmem_budget(self, vocab_size=vocab_size or 1, dim=dim,
                              negatives=negatives, batch=None)

    def describe(self) -> str:
        return f"{self.name}:{self.sampler}"


@dataclass(frozen=True)
class DenseEngine(UpdateEngine):
    """Autograd + dense gradient — the numerical oracle."""

    name = "dense"

    def make_step(self, cfg: SGNSConfig, total_steps: int):
        def step(params, centers, contexts, neg_table, seeds, step_idx):
            with span("repro_torch.step.draw"):
                negs = self.sample(neg_table, seeds, (centers.shape[1], cfg.negatives))
            lr = sgns.linear_lr(step_idx, total_steps, cfg)
            with span("repro_torch.step.update"):
                loss = sgns.train_step_dense_(params, centers, contexts, negs, lr)
            return params, sgns.worker_mean(loss)

        return step


@dataclass(frozen=True)
class SparseEngine(UpdateEngine):
    """Manual row grads + scatter-add; :meth:`row_grads` is the seam the
    row-gradient kernel plugs into."""

    name = "sparse"

    def row_grads(self):
        """``(w, c_pos, c_neg) -> (loss (N,), dW, dC_pos, dC_neg)`` on the
        step's gathered rows."""
        return sgns.sparse_row_grads_per_pair

    def make_step(self, cfg: SGNSConfig, total_steps: int):
        row_grads = self.row_grads()

        def step(params, centers, contexts, neg_table, seeds, step_idx):
            with span("repro_torch.step.draw"):
                negs = self.sample(neg_table, seeds, (centers.shape[1], cfg.negatives))
            lr = sgns.linear_lr(step_idx, total_steps, cfg)
            with span("repro_torch.step.update"):
                loss = sgns.train_step_sparse_(params, centers, contexts, negs, lr,
                                               row_grads=row_grads)
            return params, sgns.worker_mean(loss)

        return step


@dataclass(frozen=True)
class RowGradEngine(SparseEngine):
    """The sparse step with K3 computing the row gradients; the draw and
    the gather/scatter stay torch."""

    name = "rowgrad"

    def row_grads(self):
        from repro_torch.kernels.sgns_update import sgns_row_grads

        return sgns_row_grads


@dataclass(frozen=True)
class FusedEngine(UpdateEngine):
    """One kernel call per step for all workers: in-kernel alias
    negative sampling + forward + row grads + apply. Alias tables only."""

    sampler: str = "alias"
    name = "fused"

    def __post_init__(self):
        if self.sampler != "alias":
            raise ValueError(
                f"{self.name} samples in-kernel from alias tables; "
                f"sampler {self.sampler!r} is not supported")

    def sample(self, table, seeds, shape: tuple[int, ...]):
        """The kernel's counter-hash draw outside a step: ``(n, *shape)``
        ids, exactly those an in-kernel step with these ``(n, 2)`` seeds
        draws (K1 on the card, its plain version on the CPU)."""
        from repro_torch.kernels.sgns_fused import sample_negatives

        return sample_negatives(seeds, table["prob"], table["alias"], shape)

    def make_step(self, cfg: SGNSConfig, total_steps: int):
        from repro_torch.kernels.sgns_fused import sgns_fused_step

        def step(params, centers, contexts, neg_table, seeds, step_idx):
            lr = sgns.linear_lr(step_idx, total_steps, cfg)
            with span("repro_torch.step.update"):
                params, loss, _ = sgns_fused_step(
                    params, centers, contexts, neg_table, seeds, float(lr),
                    negatives=cfg.negatives)
            return params, sgns.worker_mean(loss)

        return step


@dataclass(frozen=True)
class FusedHBMEngine(FusedEngine):
    """The fused step as a chain of pair blocks (K4).

    ``block_pairs`` — pairs per block (a shorter tail block covers any
    batch remainder).
    ``sequential``  — word2vec's per-pair apply order (each pair's grads
    see every earlier pair's updates) instead of per-block semantics.
    Slower; the update-order oracle.
    """

    block_pairs: int = 256
    sequential: bool = False
    name = "fused_hbm"

    def __post_init__(self):
        super().__post_init__()
        if self.block_pairs < 1:
            raise ValueError(
                f"{self.name} needs block_pairs >= 1 (pairs per block), got "
                f"{self.block_pairs}")

    def make_step(self, cfg: SGNSConfig, total_steps: int):
        from repro_torch.kernels.sgns_fused_hbm import sgns_fused_hbm_step

        def step(params, centers, contexts, neg_table, seeds, step_idx):
            lr = sgns.linear_lr(step_idx, total_steps, cfg)
            with span("repro_torch.step.update"):
                params, loss, _ = sgns_fused_hbm_step(
                    params, centers, contexts, neg_table, seeds, float(lr),
                    negatives=cfg.negatives, block_pairs=self.block_pairs,
                    sequential=self.sequential)
            return params, sgns.worker_mean(loss)

        return step


@dataclass(frozen=True)
class FusedPipeEngine(FusedHBMEngine):
    """The block chain in one kernel launch a step (K5): K1's draw, K4a's
    two block sorts, then one persistent launch that walks each worker's
    blocks in order with the rows updated in place (no ring, no planner on
    the card). Bitwise ``fused_hbm`` at the same ``block_pairs``.

    ``ring_depth`` — the reference's ring slots (>= 2), kept for the
    plain version, which runs the reference's planner and ring; on the
    card it changes nothing.
    ``sequential`` — word2vec's per-pair order cannot be pipelined;
    ``True`` runs ``fused_hbm``'s sequential kernel (K4b).
    """

    ring_depth: int = 2
    name = "fused_pipe"

    def __post_init__(self):
        super().__post_init__()
        if self.ring_depth < 2:
            raise ValueError(
                f"{self.name} needs ring_depth >= 2 (gathers of block b+1 must "
                f"overlap scatters of block b), got {self.ring_depth}")

    def _step_fn(self):
        from repro_torch.kernels.sgns_fused_pipe import sgns_fused_pipe_step

        return sgns_fused_pipe_step, {"ring_depth": self.ring_depth}

    def make_step(self, cfg: SGNSConfig, total_steps: int):
        if self.sequential:
            return FusedHBMEngine.make_step(self, cfg, total_steps)
        fn, dials = self._step_fn()

        def step(params, centers, contexts, neg_table, seeds, step_idx):
            lr = sgns.linear_lr(step_idx, total_steps, cfg)
            with span("repro_torch.step.update"):
                params, loss, _ = fn(params, centers, contexts, neg_table, seeds,
                                     float(lr), negatives=cfg.negatives,
                                     block_pairs=self.block_pairs, **dials)
            return params, sgns.worker_mean(loss)

        return step


@dataclass(frozen=True)
class FusedTieredEngine(FusedPipeEngine):
    """``fused_pipe`` with a hot tier (K6): rows ``[0, hot_rows)`` — the
    most frequent, since vocab ids are frequency-sorted — are loaded and
    stored with a hint that keeps them in the L2 cache, the rest with one
    that evicts them first, all rows updated in place by ``fused_pipe``'s
    one launch. Bitwise ``fused_hbm`` at every ``hot_rows``.

    ``hot_rows`` — rows in the hot tier (>= 0; 0 is ``fused_pipe``). The
    trainer rejects ``hot_rows > V`` (:meth:`validate`); direct kernel
    calls clamp.
    """

    hot_rows: int = 256
    name = "fused_tiered"

    def __post_init__(self):
        super().__post_init__()
        if self.hot_rows < 0:
            raise ValueError(f"{self.name} needs hot_rows >= 0, got {self.hot_rows}")

    def validate(self, *, vocab_size: int | None = None, dim: int | None = None,
                 negatives: int | None = None) -> None:
        """Reject a hot tier larger than the table it is a prefix of."""
        super().validate(vocab_size=vocab_size, dim=dim, negatives=negatives)
        if vocab_size and self.hot_rows > vocab_size:
            raise ValueError(
                f"{self.name} hot_rows={self.hot_rows} exceeds vocab_size={vocab_size}; "
                f"the hot tier is a prefix of the (V, d) table — use hot_rows <= V "
                f"(hot_rows=V keeps every row in the hot tier)")

    def _step_fn(self):
        from repro_torch.kernels.sgns_fused_tiered import sgns_fused_tiered_step

        return sgns_fused_tiered_step, {"ring_depth": self.ring_depth,
                                        "hot_rows": self.hot_rows}


ENGINES: dict[str, type[UpdateEngine]] = {
    "dense": DenseEngine,
    "sparse": SparseEngine,
    "rowgrad": RowGradEngine,
    "fused": FusedEngine,
    "fused_hbm": FusedHBMEngine,
    "fused_pipe": FusedPipeEngine,
    "fused_tiered": FusedTieredEngine,
}
ENGINE_NAMES = tuple(ENGINES)

#: The JAX package's engine each port engine is held against.
REFERENCE_ENGINE = {"dense": "dense", "sparse": "sparse", "rowgrad": "pallas",
                    "fused": "pallas_fused", "fused_hbm": "pallas_fused_hbm",
                    "fused_pipe": "pallas_fused_pipe",
                    "fused_tiered": "pallas_fused_tiered"}


def port_engine_spec(spec: str) -> str:
    """An engine spec in either package's names, in the port's: the JAX
    package's name (``"pallas_fused_hbm:alias"``) goes through the inverse
    of :data:`REFERENCE_ENGINE`; a port name passes through."""
    name, sep, sampler = str(spec).partition(":")
    port = {ref: ours for ours, ref in REFERENCE_ENGINE.items()}.get(name, name)
    return port + sep + sampler


def get_engine(spec: str | UpdateEngine = "fused", **overrides) -> UpdateEngine:
    """Resolve an engine spec: an instance (returned as-is, or with field
    overrides applied) or a ``"name"`` / ``"name:sampler"`` string, e.g.
    ``get_engine("sparse:alias")`` or ``get_engine("fused_hbm",
    block_pairs=64)``."""
    if isinstance(spec, UpdateEngine):
        return replace(spec, **overrides) if overrides else spec
    name, _, sampler = str(spec).partition(":")
    if name not in ENGINES:
        raise ValueError(
            f"unknown update engine {name!r}; expected one of "
            f"{sorted(ENGINES)} (optionally 'name:sampler')")
    if sampler:
        overrides.setdefault("sampler", sampler)
    return ENGINES[name](**overrides)
