"""The launch phase-order checker (``repro_torch.analysis.dma_model``), on
the CPU: the port's real schedules, items and planner certify, and — what
makes the checker trustworthy, as the reference's ``tests/test_analysis.py``
mutations do — each planted fault is caught: a dropped group barrier, a
sort that skips the ``drawn`` wait, a barrier waited for one generation
early (block b read before block b − 1's writes), overlapping apply items,
a planner that zeroes its hazards; and on the card's side, a timeline that
breaks the order.
"""

from dataclasses import replace

import numpy as np
import pytest

from repro.analysis import dma_model as jdma
from repro_torch.analysis import dma_model as D
from repro_torch.kernels.sgns_block_step import apply_items
from repro_torch.kernels.sgns_fused_pipe import plan_blocks


def _small_space(schedule_fn):
    return D.check_schedule_space(max_nblocks=3, schedule_fn=schedule_fn, workers=(1, 2))


def test_shipping_schedules_certify():
    rep = D.check_schedule_space(max_nblocks=6)
    assert rep.ok, rep.summary()
    engines = {e for e, _ in D.schedule_cases()}
    assert engines == {"block", "chain"} and rep.schedules_checked > 100
    # the space holds groups of one CTA (drawing, sorting and pairs in one),
    # several workers a group, tails and more sorters than one
    geos = [g for _, g in D.schedule_cases()]
    assert any(g.group_ctas == 1 for g in geos) and any(g.groups < g.n for g in geos)
    assert any(g.tail for g in geos) and any(g.sorters > 1 for g in geos)


def test_shipping_items_and_planner_certify():
    rep = D.check_item_rules()
    assert rep.ok and rep.lists_checked > 100, rep.summary()
    rep = D.check_planner(ring_depths=(2, 3), max_nblocks=3)
    ref = jdma.check_planner(ring_depths=(2,), max_nblocks=2)
    assert rep.ok, rep.summary()
    assert ref.ok and rep.plans_checked > 0


def _drop_barrier(k):
    """The k-th group barrier taken out of the kernel (later arrivals
    renumbered, as the kernel's count would be)."""
    def fn(engine, n, nblocks, geo):
        out = []
        for e in D.launch_schedule(engine, n, nblocks, geo):
            if e.kind == "arrive" and e.gen >= k:
                if e.gen == k:
                    continue
                e = replace(e, gen=e.gen - 1)
            if e.kind == "wait" and e.target >= k:
                if e.target == k:
                    continue
                e = replace(e, target=e.target - 1)
            out.append(e)
        return out
    return fn


@pytest.mark.parametrize("k", (1, 2), ids=("pairs-applies", "between-blocks"))
def test_dropped_group_barrier_is_caught(k):
    rep = _small_space(_drop_barrier(k))
    assert not rep.ok
    rules = {v.rule for v in rep.violations}
    assert "block-order" in rules or "scratch-reuse" in rules, rules


def test_sort_that_skips_the_drawn_wait_is_caught():
    rep = _small_space(lambda *a: [e for e in D.launch_schedule(*a) if e.kind != "acquire"])
    assert not rep.ok
    assert {v.rule for v in rep.violations} == {"draw-order"}


def test_block_read_one_barrier_early_is_caught():
    """Every wait after the first passes one barrier generation early: block
    b's pairs read rows before block b − 1's applies wrote them."""
    def early(*a):
        return [replace(e, target=e.target - 1) if e.kind == "wait" and e.target >= 2 else e
                for e in D.launch_schedule(*a)]

    rep = _small_space(early)
    assert any(v.rule == "block-order" for v in rep.violations), rep.summary()


def test_a_sort_waiting_for_fewer_draws_is_caught():
    """An acquire that waits for one arrival fewer than there are drawing
    CTAs orders the sort after none of them."""
    def short(*a):
        return [replace(e, need=e.need - 1) if e.kind == "acquire" else e
                for e in D.launch_schedule(*a)]

    rep = D.check_schedule_space(max_nblocks=2, schedule_fn=short, workers=(1,))
    assert {v.rule for v in rep.violations} == {"draw-order"}


def test_overlapping_apply_items_are_caught():
    def overlap(rows, d, vec4, s0):
        it = apply_items(rows, d, vec4, s0=s0).copy()
        if len(it) > 1:
            it[0, 1] += 1                  # the first item runs into the next
        return it

    rep = D.check_item_rules(items_fn=overlap)
    rules = {v.rule for v in rep.violations}
    assert {"two-writers", "coverage"} <= rules, rep.summary()


def test_a_run_split_between_items_is_two_writers():
    rows = np.array([3, 3, 3, 7, 9, 9])
    good = np.array([[0, 3, 0, 32], [3, 3, 0, 32]])
    assert D.check_items(rows, good, 32) == []
    split = np.array([[0, 2, 0, 32], [2, 4, 0, 32]])     # row 3 in both
    assert [v.rule for v in D.check_items(rows, split, 32)] == ["two-writers"]
    narrow = np.array([[0, 3, 0, 16], [3, 3, 0, 32]])    # columns 16.. of row 3 unwritten
    assert [v.rule for v in D.check_items(rows, narrow, 32)] == ["coverage"]


def test_planner_that_drops_hazards_is_caught():
    def zero(*a, **k):
        plan = plan_blocks(*a, **k)
        return plan._replace(hazard=plan.hazard * 0)

    rep = D.check_planner(ring_depths=(2,), max_nblocks=3, plan_fn=zero)
    assert not rep.ok
    assert {v.rule for v in rep.violations} == {"war-hazard"}


@pytest.mark.parametrize("n,B,blk,sms", [(1, 80, 16, 1), (2, 80, 16, 2), (3, 75, 16, 4),
                                         (2, 48, 48, 4)])
def test_model_timeline_certifies_and_faults_are_caught(n, B, blk, sms):
    geo = D.block_geometry(n, 64, B, 2, blk, sms)
    stamps = D.model_timeline(geo)
    assert D.check_timeline(stamps, geo) == []
    # a CTA that begins block 0's applies before another ended its pairs
    if geo.group_ctas > 1:
        bad = stamps.copy()
        bad[0, 9] = bad[1, 8] - 1
        assert [v.rule for v in D.check_timeline(bad, geo)] == ["block-order"]
    # a C list's sort that loads its keys before the last draw
    bad = stamps.copy()
    first = geo.sorters if geo.group_ctas > geo.sorters else 0
    bad[first, D.STAMP_DRAWN] = bad[0, D.STAMP_KEYS] + 1
    assert "draw-order" in {v.rule for v in D.check_timeline(bad, geo)}


def test_launch_schedule_mirrors_the_kernel_loops():
    """Barrier counts a worker, which CTAs draw and sort, and the pairs each
    CTA takes (block 0 by the drawing CTAs only, later blocks by all)."""
    geo = D.LaunchGeometry(n=1, nblocks=3, blk=64, group_ctas=4, groups=1, sorters=2)
    ev = D.launch_schedule("block", 1, 3, geo)
    waits = [e for e in ev if e.kind == "wait" and e.cta == 0]
    assert [e.target for e in waits] == [1, 2, 3, 4, 5]            # 2 nblocks - 1
    assert sorted({e.cta for e in ev if e.kind == "draw"}) == [2, 3]
    assert sorted({e.cta for e in ev if e.kind == "sort"}) == [0, 1]
    pairs0 = {e.cta for e in ev if e.kind == "pairs" and e.block == 0}
    pairs1 = {e.cta for e in ev if e.kind == "pairs" and e.block == 1}
    assert pairs0 == {2, 3} and pairs1 == {0, 1, 2, 3}
    # every draw a pair of block 0 reads was written by its own CTA
    for e in ev:
        if e.kind == "pairs" and e.block == 0:
            own = next(x for x in ev if x.kind == "draw" and x.cta == e.cta)
            assert {r for r in e.reads if r[0] == "ids"} <= own.writes
    chain = D.launch_schedule("chain", 1, 3, replace(geo, sorters=0))
    assert {e.kind for e in chain if e.cta == -1} == {"draw", "sort"}
    with pytest.raises(ValueError, match="geometry"):
        D.launch_schedule("block", 2, 3, geo)


def test_dma_model_main(capsys):
    assert D.main(["--max-nblocks", "3"]) == 0
    assert "OK" in capsys.readouterr().out
