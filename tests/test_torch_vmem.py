"""The port's on-chip budget (``repro_torch.analysis.vmem``), on the CPU.

The reference's ``tests/test_analysis.py`` vmem cases on the port: the
terms scale with the dials, the budget rejects what it should (a CTA past
the budget, CTAs that cannot be resident as their launch needs, a step
past the card's memory) and passes every engine at the paper's shape. The
Python mirrors the terms come from are held to the constants in the CUDA
sources, and every kernel an estimate names to the sources' attribute
tables, so that the card check (``chip_smoke.py budget``) compares like
with like. The comparison itself is run on fabricated attributes.
"""

import re

import pytest

from repro.analysis.vmem import estimate_vmem as jestimate_vmem
from repro_torch.analysis import vmem
from repro_torch.analysis.vmem import (
    DEFAULT_VMEM_BUDGET_BYTES, VmemBudgetError, check_vmem_budget, estimate_vmem)
from repro_torch.core.engine import ENGINE_NAMES, REFERENCE_ENGINE, get_engine
from repro_torch.kernels import build
from repro_torch.kernels import sgns_block_step as S
from repro_torch.kernels import sgns_fused_hbm as H
from repro_torch.kernels import sgns_fused_pipe as P
from repro_torch.kernels import sgns_update as U
from repro_torch.kernels import swa_decode as K7

PAPER = dict(vocab_size=300_000, dim=500, negatives=5, batch=1024)
SHAPE = dict(vocab_size=2_000, dim=64, negatives=5, batch=256)


def _const(src: str, name: str) -> int:
    text = (build.CSRC / src).read_text()
    m = re.search(rf"constexpr int {name} = ([0-9* ]+);", text)
    assert m, (src, name)
    return eval(m.group(1))


def test_mirrors_are_the_kernels_constants():
    assert S.WARP_BYTES == _const("sgns_block_step.cuh", "kWarpBytes")
    assert S.STAGES == _const("sgns_block_step.cuh", "kStages")
    assert S.SPLIT_RUNS == _const("sgns_block_step.cuh", "kSplitRuns")
    assert P.CHAIN_STAGE_BYTES == _const("sgns_pipe.cuh", "kStageBytes")
    assert P.CHAIN_AHEAD == _const("sgns_pipe.cuh", "kAhead")
    assert P.CHAIN_WINDOW == _const("sgns_pipe.cuh", "kWindow")
    assert P.CHAIN_MIN_GROUP == _const("sgns_pipe.cuh", "kMinGroup")
    assert U.TILE_PAIRS == _const("sgns_row_grads.cu", "kTilePairs")
    assert U.STAGES == _const("sgns_row_grads.cu", "kStages")
    assert U.BAR_BYTES == _const("sgns_row_grads.cu", "kBarBytes")
    assert (H.SEQ_CLUSTER, H.SEQ_MAX_THREADS, H.SEQ_CHUNK) == tuple(
        _const("sgns_fused_hbm.cu", k) for k in ("kSeqCluster", "kSeqMaxThreads", "kSeqChunk"))
    assert (K7.CONSUMER_WARPS, K7.MAX_STAGES, K7.STAGE_BYTES, K7.RING_BYTES,
            K7.RING_OFFSET) == tuple(_const("swa_decode.cu", k) for k in (
                "kConsumerWarps", "kMaxStages", "kStageBytes", "kRingBytes", "kRingOffset"))
    assert U.SMEM_OPTIN == vmem.SMEM_OPTIN_BYTES == DEFAULT_VMEM_BUDGET_BYTES


def _exported(lib: str) -> set:
    return set(re.findall(r'KERNEL_ENTRY\("([^"]+)"', (build.CSRC / build.SOURCES[lib])
                          .read_text()))


@pytest.mark.parametrize("d", (48, 50, 500))
def test_every_estimated_kernel_is_exported_by_its_library(d):
    """Each instantiation an estimate names is in its source's
    ``kernel_attrs`` table, so the card check can find it."""
    shape = {**PAPER, "dim": d}
    engines = [get_engine(n) for n in ENGINE_NAMES] + [get_engine("fused_hbm", sequential=True)]
    for eng in engines:
        for k in estimate_vmem(eng, **shape).kernels:
            assert k.name in _exported(k.lib), (eng.describe(), k)
    for kw in (dict(heads=32, kv_heads=8, head_dim=80), dict(heads=16, kv_heads=16, head_dim=64)):
        for bf16 in (False, True):
            est = vmem.estimate_swa_decode(batch=4, window=4096, bf16=bf16, **kw)
            assert {k.name for k in est.kernels} <= _exported("swa_decode")


def test_every_source_exports_its_instantiations():
    counts = {lib: len(_exported(lib)) for lib in build.SOURCES}
    assert counts == {"sample_negatives": 1, "sgns_fused_step": 2, "sgns_row_grads": 8,
                      "sgns_fused_hbm": 11, "sgns_fused_pipe": 2, "sgns_fused_tiered": 2,
                      "swa_decode": 54}
    assert "func_attrs.cuh" in build.HEADERS


@pytest.mark.parametrize("eng,dial,small,large,term", [
    ("rowgrad", "dim", 48, 500, "ring"),
    ("fused_pipe", "dim", 64, 512, "warp_stages"),
    ("fused_tiered", "negatives", 2, 16, "warp_stages"),
    ("fused_hbm:sequential", "batch", 64, 1024, "staged_ids"),
    ("fused_hbm:sequential", "negatives", 5, 16, "partial_sums"),
])
def test_vmem_estimates_scale_with_dials(eng, dial, small, large, term):
    e = (get_engine("fused_hbm", sequential=True) if eng == "fused_hbm:sequential"
         else get_engine(eng))
    lo = estimate_vmem(e, **{**SHAPE, dial: small})
    hi = estimate_vmem(e, **{**SHAPE, dial: large})
    assert hi.terms[term] > lo.terms[term]
    assert hi.total_bytes > lo.total_bytes


def test_torch_only_engines_need_no_shared_memory():
    for eng in ("dense", "sparse"):
        est = estimate_vmem(eng, **SHAPE)
        assert est.total_bytes == 0 and not est.kernels
        assert est.device_terms["tables"] == 2 * SHAPE["vocab_size"] * SHAPE["dim"] * 4


@pytest.mark.parametrize("eng", ("fused", "fused_hbm", "fused_pipe"))
def test_device_terms_scale_with_workers_and_blocks(eng):
    one = estimate_vmem(eng, **SHAPE, workers=1)
    three = estimate_vmem(eng, **SHAPE, workers=3)
    assert three.device_terms["tables"] == 3 * one.device_terms["tables"]
    assert three.device_bytes > 2 * one.device_bytes
    if eng != "fused":
        small = estimate_vmem(get_engine(eng, block_pairs=32), **SHAPE)
        assert small.device_terms["dW"] < one.device_terms["dW"]


def test_block_step_scratch_matches_the_launch():
    """K2's device terms are ``run_block_step``'s scratch at the launch's
    geometry, and a C list too long for the warp regions goes to global
    scratch."""
    est = estimate_vmem("fused", **PAPER)
    geo = S.geometry(1, 500, 1024, 5, 1024, vmem.H100_SMS)
    assert est.shape["group_ctas"] == geo.group_ctas and est.shape["sorters"] == geo.sorters
    assert est.device_terms["sort_mem"] == 2 * S.sort_task_bytes(1024, 5)
    assert est.shape["sort_tasks_in_global"] == 0          # 6,144 entries: exactly 112 KiB
    big = estimate_vmem("fused", **{**PAPER, "batch": 2048})
    assert big.shape["sort_tasks_in_global"] == 1


def test_every_engine_fits_the_card_at_the_paper_shape():
    """The reference rejects its VMEM-resident tables at 300k × 500; on the
    H100 the tables live in device memory and every engine fits the
    opt-in shared memory a CTA, with two CTAs an SM where the launch needs
    them."""
    assert jestimate_vmem("pallas_fused", **PAPER).terms["resident_tables"] == \
        2 * 300_000 * 500 * 4
    for name in ENGINE_NAMES:
        est = check_vmem_budget(name, **PAPER, workers=10,
                                device_budget_bytes=80 * 10 ** 9)
        assert est.total_bytes <= DEFAULT_VMEM_BUDGET_BYTES, est.summary()
        assert REFERENCE_ENGINE[name]
    est = check_vmem_budget("fused", **PAPER)
    assert est.terms == {"warp_regions": 114_688, "barriers_scan": 288}
    assert check_vmem_budget("rowgrad", **PAPER).terms["ring"] == 2 * 112_000


def test_vmem_budget_rejects_what_it_should(monkeypatch):
    with pytest.raises(VmemBudgetError, match="budget exceeded"):
        check_vmem_budget("fused", **PAPER, budget_bytes=100 * 1024)
    assert check_vmem_budget("sparse", **PAPER, budget_bytes=100 * 1024).total_bytes == 0
    # the fused family's tables past the card's memory: 70 workers × 1.2 GB
    with pytest.raises(VmemBudgetError, match="device memory"):
        check_vmem_budget("fused", **PAPER, workers=70, device_budget_bytes=80 * 10 ** 9)
    # two CTAs an SM cannot hold two of a CTA's budget past half the SM
    fat = vmem.KernelFootprint("k", "sgns_fused_step", 0, 120_000, 2, 128)
    est = vmem.VmemEstimate("fat", {}, {"x": 120_000}, (fat,))
    monkeypatch.setattr(vmem, "estimate_vmem", lambda *a, **k: est)
    with pytest.raises(VmemBudgetError, match="resident"):
        check_vmem_budget("fused", **PAPER)


def test_engine_validate_runs_the_budget():
    """The trainer's ``engine.validate`` checks the kernels' shared memory."""
    get_engine("fused").validate(vocab_size=100, dim=500, negatives=5)
    get_engine("fused_hbm", sequential=True).validate(vocab_size=100, dim=500, negatives=16)
    with pytest.raises(ValueError, match="hot_rows"):
        get_engine("fused_tiered", hot_rows=200).validate(vocab_size=100, dim=8, negatives=5)


def test_card_check_compares_static_and_dynamic(monkeypatch):
    est = estimate_vmem("fused_pipe", **PAPER)
    good = {k.name: build.KernelAttrs(k.name, 96, k.static_smem, k.dynamic_smem, 0)
            for k in est.kernels}
    monkeypatch.setattr(build, "kernel_attributes", lambda lib: list(good.values()))
    rows = vmem.card_check(est)
    assert [r["match"] for r in rows] == [True, True]
    name = est.kernels[1].name
    good[name] = good[name]._replace(dynamic_smem=good[name].dynamic_smem + 16, local_bytes=36)
    rows = vmem.card_check(est)
    assert [r["match"] for r in rows] == [True, False] and rows[1]["spill_bytes"] == 36
    monkeypatch.setattr(build, "kernel_attributes", lambda lib: [])
    with pytest.raises(KeyError, match="exports no kernel"):
        vmem.card_check(est)


def test_vmem_main_reports_every_engine(capsys):
    assert vmem.main([]) == 0
    out = capsys.readouterr().out
    assert out.count("vmem: ") == len(ENGINE_NAMES) + 1 and "REJECTED" not in out
    assert vmem.main(["--engine", "fused", "--budget-mb", "0.05"]) == 1
    assert "REJECTED" in capsys.readouterr().out
