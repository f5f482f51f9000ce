"""Static on-chip budget of the port's kernels, and the device memory of a
step, checked before anything is launched.

The counterpart of ``repro.analysis.vmem``. There, "VMEM" is the TPU
core's fast memory, and the pass computes each Pallas engine's resident
working set so that a configuration past the cliff is refused at plan
time. On the H100 the memory a kernel is built against is each CTA's
**shared memory** (227 KiB a CTA by opt-in, 232,448 bytes; 228 KiB an SM,
shared by the CTAs resident there) and its **registers** (65,536 an SM, at
most 255 a thread, bounded further by each kernel's ``__launch_bounds__``).
The terms are computed from the Python mirrors of the kernels' constants
(``kernels/sgns_block_step.py``, ``sgns_update.py``, ``sgns_fused_pipe.py``,
``sgns_fused_hbm.py``, ``swa_decode.py``), never from a TPU figure:

* K2/K4a (``fused``, ``fused_hbm``): eight warp regions of 14,336 bytes and
  the static mbarriers and scan sums; a sort task whose list does not fit
  the regions sorts in global scratch instead (``sort_need``);
* K3 (``rowgrad``): the ring of ``STAGES`` stages of ``TILE_PAIRS`` pairs
  (224 KB at d = 500) and its barriers;
* K5/K6 (``fused_pipe``, ``fused_tiered``): a stage a warp;
* K4b (``sequential=True``): a cluster of 8 CTAs, each with its partial-sum
  slots and a chunk's staged ids;
* K7 (:func:`estimate_swa_decode`): the K/V ring of the partial kernel.

The H100's counterpart of the reference's ``resident_tables`` cliff is
device memory, so each estimate also carries the step's device terms: the
``n × 2 × V × d`` tables, the noise tables and the scratch each launch
allocates (``run_block_step``'s ``coef``, ``dW``, ``wrows``, ``items``,
``sort_mem``, ...).

Where it runs: :class:`~repro_torch.core.async_trainer.AsyncShardTrainer`
checks the engine when it is built (``engine.validate``); ``train_sgns``
and ``dryrun_sgns`` print the ``vmem:`` line and enforce
``--vmem-budget-mb``; ``python -m repro_torch.analysis vmem`` certifies
every engine at the paper's shape. On the card, :func:`card_check` holds
the shared-memory terms to what ``cudaFuncGetAttributes`` reports for each
instantiation, and reports registers and spills.

Standalone: ``python -m repro_torch.analysis.vmem --engine fused_pipe
--vocab 300000 --dim 500``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

F32 = 4
#: Shared memory a CTA may opt into on an H100 (227 KiB), and an SM's (228
#: KiB), of which the runtime reserves 1 KiB a resident CTA.
SMEM_OPTIN_BYTES = 232_448
SMEM_SM_BYTES = 233_472
SMEM_RESERVED_BYTES = 1024
#: The default budget: the card's opt-in limit a CTA. ``--vmem-budget-mb``
#: takes it in MiB (0.2216796875); 0 reports without enforcing.
DEFAULT_VMEM_BUDGET_BYTES = SMEM_OPTIN_BYTES
H100_SMS = 132


class VmemBudgetError(ValueError):
    """An engine's on-chip footprint exceeds the budget, or its kernels
    cannot be resident as their launches require."""


@dataclass(frozen=True)
class KernelFootprint:
    """One kernel instantiation a step launches, as its launch sizes it."""

    name: str            # as the library's ``kernel_attrs`` names it
    lib: str             # ``kernels.build.SOURCES`` key
    static_smem: int
    dynamic_smem: int
    ctas_per_sm: int     # CTAs an SM the launch needs resident at once (0: no need)
    max_regs: int        # registers a thread its launch bounds allow

    @property
    def smem(self) -> int:
        return self.static_smem + self.dynamic_smem


@dataclass(frozen=True)
class VmemEstimate:
    """On-chip footprint of one engine at one shape, and its step's device
    memory. ``terms`` are the budgeted bytes a CTA of the engine's largest
    kernel; ``device_terms`` bytes of device memory (empty without a
    batch)."""

    engine: str
    shape: dict = field(default_factory=dict)
    terms: dict = field(default_factory=dict)
    kernels: tuple = ()
    device_terms: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.terms.values())

    @property
    def device_bytes(self) -> int:
        return sum(self.device_terms.values())

    def summary(self) -> str:
        kib = self.total_bytes / 1024
        parts = ", ".join(f"{k}={v / 1024:.2f}KiB"
                          for k, v in sorted(self.terms.items(), key=lambda kv: -kv[1]))
        regs = ", ".join(f"{k.name}<={k.max_regs}" for k in self.kernels)
        head = (f"{self.engine}: {kib:.2f} KiB shared memory a CTA "
                f"({parts or 'no kernel of its own'})")
        if regs:
            head += f"; registers a thread {regs}"
        if self.device_terms:
            dev = ", ".join(f"{k}={v / 1e6:.1f}MB" for k, v in
                            sorted(self.device_terms.items(), key=lambda kv: -kv[1])[:4])
            head += f"; device {self.device_bytes / 1e9:.3f} GB ({dev})"
        return head


def _regs(threads: int, ctas_per_sm: int) -> int:
    """Registers a thread ``__launch_bounds__(threads, ctas_per_sm)`` allows."""
    return min(255, 65_536 // (threads * max(ctas_per_sm, 1)) // 8 * 8)


def _k1() -> KernelFootprint:
    return KernelFootprint("sample_negatives_kernel", "sample_negatives", 0, 0, 0, 255)


def _block_step(lib: str, vec4: bool, logsig: bool) -> KernelFootprint:
    from repro_torch.kernels import sgns_block_step as S

    name = f"block_step_kernel<{str(vec4).lower()},{str(logsig).lower()}>"
    return KernelFootprint(name, lib, S.STATIC_SMEM_BYTES, S.SMEM_BYTES, S.CTAS_PER_SM,
                           _regs(S.WARPS * 32, S.CTAS_PER_SM))


def _block_terms(V, d, K, B, blk, n, sms, vec4, shape, terms, dev) -> None:
    """K2's/K4a's terms: the warp regions and static barriers a CTA, the
    sort tasks that go to global scratch, and the launch's scratch."""
    import numpy as np

    from repro_torch.kernels import sgns_block_step as S

    terms["warp_regions"] = S.SMEM_BYTES
    terms["barriers_scan"] = S.STATIC_SMEM_BYTES
    if B is None:
        return
    geo = S.geometry(n, d, B, K, blk, sms, vec4)
    lists = [min(geo.blk, B - b * geo.blk) for b in range(geo.nblocks)]
    shape.update(block_pairs=geo.blk, nblocks=geo.nblocks, group_ctas=geo.group_ctas,
                 groups=geo.groups, sorters=geo.sorters,
                 sort_tasks_in_global=sum(S.sort_need(nb * (K + 1)) > S.SMEM_BYTES
                                          for nb in lists)
                 + sum(S.sort_need(nb) > S.SMEM_BYTES for nb in lists))
    for name, (dtype, shp) in S.launch_scratch(n, d, B, K, geo).items():
        dev[name] = int(np.prod(shp)) * dtype.itemsize
    dev["loss"] = n * B * F32
    dev["ids"] = n * B * K * 4


def estimate_vmem(engine, *, vocab_size: int, dim: int, negatives: int,
                  batch: int | None, workers: int = 1, sms: int = H100_SMS) -> VmemEstimate:
    """On-chip footprint of one step of ``engine`` (an
    :class:`~repro_torch.core.engine.UpdateEngine` or spec) at this shape,
    and, with a ``batch``, the device memory of ``workers`` stacked
    sub-models and the step's scratch on a card of ``sms`` SMs. ``dense``
    and ``sparse`` run torch ops only: no on-chip term of their own."""
    from repro_torch.core.engine import get_engine
    from repro_torch.kernels.sgns_fused_hbm import pick_block_pairs

    eng = get_engine(engine)
    V, d, K, B, n = vocab_size, dim, negatives, batch, workers
    shape = {"V": V, "d": d, "K": K, "B": B, "n": n}
    terms: dict[str, int] = {}
    dev: dict[str, int] = {}
    kernels: list[KernelFootprint] = []
    vec4 = d % 4 == 0
    name = eng.name
    if B is not None:
        dev["tables"] = n * 2 * V * d * F32
        dev["noise_tables"] = n * V * (8 if eng.table_kind == "alias" else F32)
    sequential = getattr(eng, "sequential", False)
    if name in ("dense", "sparse", "rowgrad") and B is not None:
        dev["gathered_rows"] = n * B * (K + 2) * d * F32
        dev["negative_ids"] = n * B * K * 8
        dev["row_grads" if name != "dense" else "dense_grads"] = (
            n * B * (K + 2) * d * F32 if name != "dense" else 2 * n * V * d * F32)
    if name == "rowgrad":
        from repro_torch.kernels import sgns_update as U

        ring = U.ring_shape(d, K)
        kmax = 8 if K <= 8 else 16
        vec = 4 if vec4 else 1
        shape["tile_pairs"] = ring.tile
        if ring.tile:
            kernels.append(KernelFootprint(f"row_grads_ring_kernel<{vec},{kmax}>",
                                           "sgns_row_grads", 0, ring.smem_bytes, 1,
                                           _regs((U.TILE_PAIRS + 1) * 32, 1)))
            terms["ring"] = ring.smem_bytes - U.BAR_BYTES
            terms["ring_barriers"] = U.BAR_BYTES
        else:
            kernels.append(KernelFootprint(f"row_grads_in_place_kernel<{vec},{kmax}>",
                                           "sgns_row_grads", 0, 0, 0, 255))
    elif name == "fused":
        kernels.append(_block_step("sgns_fused_step", vec4, False))
        _block_terms(V, d, K, B, B or 1, n, sms, vec4, shape, terms, dev)
    elif name in ("fused_hbm", "fused_pipe", "fused_tiered") and sequential:
        from repro_torch.kernels import sgns_fused_hbm as H

        seq = H.sequential_shape(d, B or H.SEQ_CHUNK, K)
        shape.update(cluster=H.SEQ_CLUSTER, threads=seq.threads)
        kernels += [_k1(), KernelFootprint(f"sgns_sequential_kernel<{seq.km},{seq.cpt}>",
                                            "sgns_fused_hbm", seq.static_smem,
                                            seq.dynamic_smem, 1, _regs(H.SEQ_MAX_THREADS, 1))]
        terms["staged_ids"] = seq.dynamic_smem
        terms["partial_sums"] = seq.static_smem
        if B is not None:
            dev.update(ids=n * B * K * 4, loss=n * B * F32)
    elif name == "fused_hbm":
        blk = pick_block_pairs(B or eng.block_pairs, eng.block_pairs)
        kernels.append(_block_step("sgns_fused_hbm", vec4, True))
        _block_terms(V, d, K, B, blk, n, sms, vec4, shape, terms, dev)
    elif name in ("fused_pipe", "fused_tiered"):
        from repro_torch.kernels import sgns_fused_pipe as P

        vec = 4 if vec4 else 1
        smem = P.chain_smem(d, K, vec)
        tiered = name == "fused_tiered"
        kernels += [_k1(), KernelFootprint(
            f"pipe_chain_kernel<{vec},{str(tiered).lower()}>",
            "sgns_fused_tiered" if tiered else "sgns_fused_pipe", 0, smem, 2,
            _regs(P.CHAIN_WARPS * 32, 2))]
        terms["warp_stages"] = smem
        if tiered:
            shape["hot_rows"] = max(0, min(int(eng.hot_rows), V))
        if B is not None:
            blk = pick_block_pairs(B, eng.block_pairs)
            Lc = B * (K + 1)
            shape["block_pairs"] = blk
            dev.update(ids=n * B * K * 4, loss=n * B * F32,
                       block_sorts=n * (B + Lc) * (4 + 8),
                       coef=n * blk * (K + 1) * F32, dW=n * blk * d * F32,
                       wrows=n * blk * d * F32, arrive=n * 4)
    return VmemEstimate(eng.describe(), shape, terms, tuple(kernels), dev)


def estimate_swa_decode(*, batch: int, window: int, heads: int, kv_heads: int,
                        head_dim: int, bf16: bool = False) -> VmemEstimate:
    """K7's footprint at a decode shape: the partial kernel's K/V ring and
    the merge kernel's weights, and the call's scratch."""
    from repro_torch.kernels.swa_decode import CONSUMER_WARPS, swa_shape

    elem = 2 if bf16 else 4
    s = swa_shape(window, heads, kv_heads, head_dim, elem)
    t = "bf16" if bf16 else "float"
    # the merge kernel's 20 bytes of static variables are padded to 128: every
    # kernel of a source shares one dynamic region, which the partial kernel
    # aligns to 128 bytes (``extern __shared__ __align__(128)``)
    kernels = (KernelFootprint(f"swa_partial_kernel<{t},{s.nc},{s.qp},{str(s.multi).lower()}>",
                               "swa_decode", 0, s.smem, 1, _regs((CONSUMER_WARPS + 1) * 32, 1)),
               KernelFootprint(f"swa_combine_kernel<{t}>", "swa_decode", 128, 0, 0, 255))
    shape = {"B": batch, "W": window, "H": heads, "Hkv": kv_heads, "D": head_dim,
             "rows": s.rows, "stages": s.stages}
    terms = {"kv_ring": s.smem - 128, "ring_barriers": 128}
    dev = {"kv_cache": 2 * batch * window * kv_heads * head_dim * elem}
    return VmemEstimate(f"swa_decode:{t}", shape, terms, kernels, dev)


def check_vmem_budget(engine, *, vocab_size: int, dim: int, negatives: int,
                      batch: int | None, budget_bytes: int = DEFAULT_VMEM_BUDGET_BYTES,
                      workers: int = 1, device_budget_bytes: int | None = None,
                      ) -> VmemEstimate:
    """Estimate and enforce: raises :class:`VmemBudgetError` with the
    per-term breakdown when a CTA's shared memory exceeds ``budget_bytes``,
    when the CTAs a launch needs resident on an SM do not fit it, or when
    the step's device memory exceeds ``device_budget_bytes`` (if given);
    returns the estimate otherwise."""
    est = estimate_vmem(engine, vocab_size=vocab_size, dim=dim, negatives=negatives,
                        batch=batch, workers=workers)
    if est.total_bytes > budget_bytes:
        raise VmemBudgetError(
            f"shared-memory budget exceeded: {est.summary()} > "
            f"{budget_bytes / 1024:.2f} KiB budget")
    for k in est.kernels:
        if k.smem > SMEM_OPTIN_BYTES or (
                k.ctas_per_sm * (k.smem + SMEM_RESERVED_BYTES) > SMEM_SM_BYTES):
            raise VmemBudgetError(
                f"{k.name}: {k.smem} bytes a CTA cannot have {k.ctas_per_sm} CTAs resident "
                f"on an SM of {SMEM_SM_BYTES} bytes ({est.summary()})")
    if device_budget_bytes is not None and est.device_bytes > device_budget_bytes:
        raise VmemBudgetError(
            f"device memory exceeded: {est.summary()} > "
            f"{device_budget_bytes / 1e9:.1f} GB — reduce the workers a card holds")
    return est


def card_check(est: VmemEstimate) -> list[dict]:
    """Each kernel of ``est`` held to ``cudaFuncGetAttributes`` on the
    current device (call it after the kernels have run at the estimate's
    shape: a launch sets the dynamic shared memory it takes). One row a
    kernel: the estimate's and the card's static and dynamic shared memory,
    ``match``, and the card's registers a thread and local memory (spills)."""
    from repro_torch.kernels import build

    rows = []
    for k in est.kernels:
        attrs = {a.name: a for a in build.kernel_attributes(k.lib)}
        if k.name not in attrs:
            raise KeyError(f"{k.lib} exports no kernel {k.name}; it has {sorted(attrs)}")
        a = attrs[k.name]
        rows.append({"kernel": k.name, "lib": k.lib, "static": k.static_smem,
                     "card_static": a.static_smem, "dynamic": k.dynamic_smem,
                     "card_dynamic": a.dynamic_smem, "regs": a.regs,
                     "max_regs": k.max_regs, "spill_bytes": a.local_bytes,
                     "match": (a.static_smem == k.static_smem
                               and (k.dynamic_smem == 0 or a.dynamic_smem == k.dynamic_smem))})
    return rows


def main(argv=None) -> int:
    import argparse

    from repro_torch.core.engine import ENGINE_NAMES, get_engine

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", default=None,
                    help="one engine spec (default: every registered engine, and "
                         "fused_hbm sequential)")
    ap.add_argument("--vocab", type=int, default=300_000)
    ap.add_argument("--dim", type=int, default=500)
    ap.add_argument("--negatives", type=int, default=5)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--hot-rows", type=int, default=None)
    ap.add_argument("--ring-depth", type=int, default=None)
    ap.add_argument("--block-pairs", type=int, default=None)
    ap.add_argument("--budget-mb", type=float, default=DEFAULT_VMEM_BUDGET_BYTES / 2 ** 20,
                    help="shared-memory budget a CTA in MiB (default the H100's opt-in "
                         "227 KiB); 0 disables enforcement (report only)")
    args = ap.parse_args(argv)
    overrides = {k: v for k, v in (("hot_rows", args.hot_rows),
                                   ("ring_depth", args.ring_depth),
                                   ("block_pairs", args.block_pairs))
                 if v is not None}
    engines = ([get_engine(args.engine)] if args.engine else
               [get_engine(n) for n in ENGINE_NAMES] + [get_engine("fused_hbm", sequential=True)])
    ok = True
    for eng in engines:
        eng = get_engine(eng, **{k: v for k, v in overrides.items() if hasattr(eng, k)})
        kw = dict(vocab_size=args.vocab, dim=args.dim, negatives=args.negatives,
                  batch=args.batch, workers=args.workers)
        try:
            est = (check_vmem_budget(eng, budget_bytes=int(args.budget_mb * 2 ** 20), **kw)
                   if args.budget_mb else estimate_vmem(eng, **kw))
            label = " (sequential)" if getattr(eng, "sequential", False) else ""
            print(f"vmem: {est.summary()}{label}")
        except VmemBudgetError as e:
            ok = False
            print(f"vmem: REJECTED {e}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
