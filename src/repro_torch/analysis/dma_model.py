"""Model checker of the port's launch phase order (K2/K4a and K5/K6).

The counterpart of ``repro.analysis.dma_model``. The reference checks the
DMA schedule its pipelined Pallas kernels share (``kernel_schedule`` /
``resolve_schedule``): matched starts and waits, no ring slot rewritten
under a copy in flight, no write-after-read hazard outside the planner's
look-behind window. The port's kernels have no DMA ring; what keeps a step
right on the H100 is the order of each launch's phases across CTAs that
run at once. So this is a redesign with the reference's aims:

* :func:`launch_schedule` — the event list of one launch, mirroring the
  kernels' loops: for K2/K4a (``csrc/sgns_block_step.cuh``,
  ``block_step_kernel``) each group of CTAs walks its workers; in block 0
  the drawing CTAs make the worker's draw and release the ``drawn``
  counter, the sorting CTAs sort each (block, table) list (a C list after
  acquiring ``drawn``), then per block the pairs phase, the group barrier,
  the applies and, between blocks, the group barrier; for K5/K6
  (``csrc/sgns_pipe.cuh``, ``pipe_chain_kernel``) the draw and the sorts
  run before the launch and each block is pairs | barrier | applies |
  barrier. Each event names what it reads and writes: a pair's negatives,
  a sort task's list, a pair's scratch (coefficients, dW, the W row), the
  worker's table rows.
* :func:`check_events` — builds the happens-before order (program order on
  each CTA; a group barrier's arrivals before its waits; the ``drawn``
  releases before the acquire that waits for all of them; the host's work
  before the launch) and reports a :class:`Violation` for every two
  conflicting accesses it leaves unordered, or ordered against the
  sequential step: a read of block b's rows not behind a barrier after
  every write of block b − 1, a sort or a pair reading negatives before
  their draw has arrived, applies reading a list before its sort ended or
  scratch the next block's pairs may already overwrite, and two writers of
  one location in one phase.
* :func:`check_items` — the apply items of one sorted list: every (row,
  column) the list touches written by exactly one item, and no row split
  between two items; :func:`check_item_rules` drives it over real ids
  through the port's item rules (``sgns_block_step.apply_items`` with
  ``SPLIT_RUNS``, the 4-byte path at d = 50, tail blocks; K5/K6's
  ``chain_items`` over ``block_sorts``), and :func:`check_planner` holds
  ``sgns_fused_pipe.plan_blocks``' hazard flags to an independent numpy
  oracle over every bounded overlap pattern (the reference's construction).
* :func:`check_schedule_space` — the checker over n ∈ {1, 2, 3}, up to 6
  blocks, and the group and sorter counts the launches' geometry gives.
* :func:`check_timeline` — on the card, the ``stamps`` variant of
  ``analysis/block_step_variants.py`` records each CTA's ``%globaltimer``
  marks; the observed order must be the model's: no CTA begins block b's
  applies before every CTA of its group has ended block b's pairs, no CTA
  passes the barrier that ends block b before every CTA has ended its
  applies, and the C lists' sorts load their keys after every draw.

The planted-fault tests (``tests/test_torch_dma_model.py``) feed the
checker a dropped group barrier, a sort that skips the ``drawn`` wait, a
barrier waited for one generation early, overlapping apply items and a
planner that zeroes its hazards, and assert each is flagged.

Standalone: ``python -m repro_torch.analysis.dma_model``.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np

ENGINES = ("block", "chain")       # K2/K4a's launch; K5/K6's
_WARPS = 8


@dataclass(frozen=True)
class Violation:
    """One breach of the launch's phase order or item rule."""

    rule: str     # block-order | draw-order | sort-order | scratch-reuse | two-writers | coverage | war-hazard
    detail: str
    where: str = ""

    def __str__(self) -> str:
        return f"[{self.rule}] {self.where}: {self.detail}"


@dataclass
class ModelCheckReport:
    schedules_checked: int = 0
    lists_checked: int = 0
    plans_checked: int = 0
    violations: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def merge(self, other: "ModelCheckReport") -> "ModelCheckReport":
        self.schedules_checked += other.schedules_checked
        self.lists_checked += other.lists_checked
        self.plans_checked += other.plans_checked
        self.violations.extend(other.violations)
        return self

    def summary(self) -> str:
        head = (f"{self.schedules_checked} launch schedules, {self.lists_checked} item "
                f"lists, {self.plans_checked} planner cases checked: "
                f"{'OK' if self.ok else f'{len(self.violations)} violation(s)'}")
        return "\n".join([head] + [f"  {v}" for v in self.violations[:20]])


@dataclass(frozen=True)
class Event:
    """One step of one CTA (``cta == -1``: the host's stream before the
    launch). ``kind``: draw | release | acquire | sort | pairs | arrive |
    wait | applies. ``phase`` is the event's place in its worker's
    sequential step (draw 0, sorts 1, pairs of block b 2 + 2b, its applies
    3 + 2b); ``gen`` a barrier's arrival number, ``target`` the number a
    wait waits for; ``need`` the arrivals an acquire waits for."""

    cta: int
    kind: str
    worker: int = -1
    block: int = -1
    phase: int = -1
    reads: frozenset = frozenset()
    writes: frozenset = frozenset()
    group: int = -1
    gen: int = 0
    target: int = 0
    need: int = 0


@dataclass(frozen=True)
class LaunchGeometry:
    """What the schedule depends on: workers, blocks, pairs a block (the
    last one ``tail`` pairs; 0: full), CTAs a group, groups, sorters."""

    n: int
    nblocks: int
    blk: int
    group_ctas: int
    groups: int
    sorters: int = 0
    tail: int = 0

    def pairs(self, b: int) -> int:
        return self.tail if (self.tail and b == self.nblocks - 1) else self.blk


def block_geometry(n: int, d: int, B: int, K: int, blk: int, sms: int,
                   vec4: bool = True) -> LaunchGeometry:
    """K2/K4a's launch shape (``sgns_block_step.geometry``)."""
    from repro_torch.kernels.sgns_block_step import geometry

    g = geometry(n, d, B, K, blk, sms, vec4)
    tail = B - (g.nblocks - 1) * g.blk
    return LaunchGeometry(n, g.nblocks, g.blk, g.group_ctas, g.groups, g.sorters,
                          0 if tail == g.blk else tail)


def chain_geometry(n: int, d: int, B: int, K: int, blk: int, capacity: int,
                   vec4: bool = True) -> LaunchGeometry:
    """K5/K6's launch shape (``sgns_fused_pipe.chain_geometry``)."""
    from repro_torch.kernels.sgns_fused_pipe import chain_geometry as cg

    blk = max(1, min(int(blk), B))
    nblocks = -(-B // blk)
    per, groups = cg(n, d, B, K, blk, capacity, 4 if vec4 else 1)
    tail = B - (nblocks - 1) * blk
    return LaunchGeometry(n, nblocks, blk, per, groups, 0, 0 if tail == blk else tail)


def _ids(w, b, blk, js):
    return frozenset(("ids", w, b * blk + j) for j in js)


def _scratch(w, js):
    return frozenset(("scratch", w, j) for j in js)


def launch_schedule(engine: str, n: int, nblocks: int, geo: LaunchGeometry) -> list[Event]:
    """The events of one launch of ``engine`` (``"block"``: K2/K4a,
    ``"chain"``: K5/K6) in each CTA's program order, CTA by CTA (the host's
    events first). ``n`` and ``nblocks`` must be the geometry's."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    if (n, nblocks) != (geo.n, geo.nblocks):
        raise ValueError(f"the geometry is for n={geo.n}, nblocks={geo.nblocks}")
    G = geo.group_ctas
    rows = lambda w: frozenset({("rows", w)})
    events: list[Event] = []
    if engine == "chain":       # K1's draw and the torch block sorts, stream-ordered before
        for w in range(n):
            events.append(Event(-1, "draw", w, phase=0, writes=frozenset().union(
                *[_ids(w, b, geo.blk, range(geo.pairs(b))) for b in range(nblocks)])))
            for t in range(2 * nblocks):
                b = t // 2
                reads = _ids(w, b, geo.blk, range(geo.pairs(b))) if t % 2 == 0 else frozenset()
                events.append(Event(-1, "sort", w, b, 1, reads, frozenset({("list", w, t)})))
    for cta in range(geo.groups * G):
        g, rank = divmod(cta, G)
        arrivals = 0
        first_rank = geo.sorters if (engine == "block" and G > geo.sorters) else 0
        drawers = G - first_rank
        for w in range(g, n, geo.groups):
            for b in range(nblocks):
                nb = geo.pairs(b)
                first = first_rank if b == 0 else 0
                if engine == "block" and b == 0:
                    if rank >= first:
                        gw = drawers * _WARPS
                        mine = [j for j in range(geo.blk) if (j % gw) // _WARPS == rank - first]
                        writes = frozenset().union(*[_ids(w, bb, geo.blk, [j for j in mine
                                                                          if j < geo.pairs(bb)])
                                                     for bb in range(nblocks)])
                        events.append(Event(cta, "draw", w, phase=0, writes=writes))
                        events.append(Event(cta, "release", w, group=g))
                    if rank < geo.sorters:
                        for t in range(rank, 2 * nblocks, geo.sorters):
                            tb = t // 2
                            reads = frozenset()
                            if t % 2 == 0:
                                events.append(Event(cta, "acquire", w, group=g, need=drawers))
                                reads = _ids(w, tb, geo.blk, range(geo.pairs(tb)))
                            events.append(Event(cta, "sort", w, tb, 1, reads,
                                                frozenset({("list", w, t)})))
                if rank >= first:
                    gwarps = (G - first) * _WARPS
                    lo = (rank - first) * _WARPS
                    js = [j for j in range(nb) if lo <= j % gwarps < lo + _WARPS]
                    if js:
                        events.append(Event(cta, "pairs", w, b, 2 + 2 * b,
                                            _ids(w, b, geo.blk, js) | rows(w), _scratch(w, js)))
                arrivals += 1
                events += [Event(cta, "arrive", group=g, gen=arrivals),
                           Event(cta, "wait", group=g, target=arrivals)]
                events.append(Event(cta, "applies", w, b, 3 + 2 * b,
                                    frozenset({("list", w, 2 * b), ("list", w, 2 * b + 1)})
                                    | _scratch(w, range(nb)), rows(w)))
                if b + 1 < nblocks:
                    arrivals += 1
                    events += [Event(cta, "arrive", group=g, gen=arrivals),
                               Event(cta, "wait", group=g, target=arrivals)]
    return events


def _happens_before(events: list[Event]) -> list[int]:
    """Each event's ancestors as a bitset (bit i: event i happens before)."""
    N = len(events)
    preds: list[list[int]] = [[] for _ in range(N)]
    last: dict[int, int] = {}
    host = [i for i, e in enumerate(events) if e.cta == -1]
    arrive: dict[tuple, list[int]] = {}
    group_of: dict[int, int] = {}
    releases: dict[int, list[int]] = {}
    for i, e in enumerate(events):
        if e.cta in last:
            preds[i].append(last[e.cta])
        elif e.cta != -1 and host:
            preds[i].extend(host)           # the launch follows the host's work
        last[e.cta] = i
        if e.kind == "arrive":
            arrive.setdefault((e.group, e.cta), []).append(i)
            group_of[e.cta] = e.group
        if e.kind == "release":
            releases.setdefault(e.worker, []).append(i)
    members: dict[int, list[int]] = {}
    for cta, g in group_of.items():
        members.setdefault(g, []).append(cta)
    for i, e in enumerate(events):
        if e.kind == "wait":
            # the counter reaches target × G only once every CTA of the group
            # has arrived `target` times
            for cta in members.get(e.group, []):
                preds[i].extend(arrive[(e.group, cta)][:e.target])
        elif e.kind == "acquire":
            rel = releases.get(e.worker, [])
            if e.need >= len(rel) and e.need > 0:
                preds[i].extend(rel)
    indeg = [0] * N
    succ: list[list[int]] = [[] for _ in range(N)]
    for i, ps in enumerate(preds):
        for p in ps:
            succ[p].append(i)
            indeg[i] += 1
    anc = [0] * N
    ready = [i for i in range(N) if indeg[i] == 0]
    seen = 0
    while ready:
        i = ready.pop()
        seen += 1
        for p in preds[i]:
            anc[i] |= anc[p] | (1 << p)
        for s in succ[i]:
            indeg[s] -= 1
            if indeg[s] == 0:
                ready.append(s)
    if seen != N:
        raise ValueError("the schedule's order has a cycle")
    return anc


def _rule(loc_kind: str) -> str:
    if loc_kind == "rows":
        return "block-order"
    if loc_kind == "ids":
        return "draw-order"
    if loc_kind == "list":
        return "sort-order"
    return "scratch-reuse"


def check_events(events: list[Event], where: str = "") -> list[Violation]:
    """Every two conflicting accesses of the launch (one writes what the
    other reads or writes) must be ordered by happens-before in the order
    of the sequential step (lower ``phase`` first). Same-phase writes of
    the rows (two CTAs' applies) are the items' business
    (:func:`check_items`); any other same-phase conflict is reported."""
    anc = _happens_before(events)
    access: dict[tuple, list[tuple[int, bool]]] = {}
    for i, e in enumerate(events):
        for loc in e.reads:
            access.setdefault(loc, []).append((i, False))
        for loc in e.writes:
            access.setdefault(loc, []).append((i, True))
    out: list[Violation] = []
    seen: set = set()
    for loc, acc in access.items():
        for (i, wi), (j, wj) in itertools.combinations(acc, 2):
            if i == j or not (wi or wj):
                continue
            a, b = events[i], events[j]
            if a.phase == b.phase:
                if loc[0] == "rows" and wi and wj:
                    continue
                if wi and wj:
                    rule, detail = "two-writers", f"{a.kind} and {b.kind} both write {loc}"
                else:
                    continue
            else:
                first, then = (i, j) if a.phase < b.phase else (j, i)
                if anc[then] >> first & 1:
                    continue
                e1, e2 = events[first], events[then]
                rule = _rule(loc[0])
                detail = (f"CTA {e2.cta}'s {e2.kind} (worker {e2.worker}, block {e2.block}) "
                          f"touches {loc} without waiting for CTA {e1.cta}'s {e1.kind} "
                          f"(block {e1.block})")
            key = (rule, a.kind, b.kind, a.block, b.block, loc[0])
            if key not in seen:
                seen.add(key)
                out.append(Violation(rule, detail, where))
    return out


# ---------------------------------------------------------------------------
# The space of launches
# ---------------------------------------------------------------------------
def schedule_cases(max_nblocks: int = 6, workers=(1, 2, 3), sms=(1, 2, 4),
                   block_pairs=(8, 16, 64)):
    """``(engine, geometry)`` for every launch shape in the bound: blocks of
    ``block_pairs`` pairs (and a tail 5 pairs short) at d = 64, K = 2, on
    cards of ``sms`` SMs, deduplicated: groups of one CTA to eight, one
    sorter to four, a group walking one worker or several."""
    from repro_torch.kernels.sgns_block_step import CTAS_PER_SM

    seen = set()
    for n, nb, s, blk, tail in itertools.product(workers, range(1, max_nblocks + 1), sms,
                                                 block_pairs, (0, 5)):
        B = blk * nb - (tail if nb > 1 else 0)
        for engine, geo in (("block", block_geometry(n, 64, B, 2, blk, s)),
                            ("chain", chain_geometry(n, 64, B, 2, blk, CTAS_PER_SM * s))):
            if (engine, geo) not in seen:
                seen.add((engine, geo))
                yield engine, geo


def check_schedule_space(max_nblocks: int = 6, schedule_fn=launch_schedule,
                         workers=(1, 2, 3)) -> ModelCheckReport:
    """:func:`check_events` over every launch shape of
    :func:`schedule_cases`; ``schedule_fn`` is injectable so that the
    planted-fault tests can hand the checker a defective schedule."""
    rep = ModelCheckReport()
    for engine, geo in schedule_cases(max_nblocks, workers):
        where = (f"{engine} n={geo.n} nblocks={geo.nblocks} group={geo.group_ctas}x"
                 f"{geo.groups} sorters={geo.sorters} tail={geo.tail}")
        rep.violations += check_events(schedule_fn(engine, geo.n, geo.nblocks, geo), where)
        rep.schedules_checked += 1
    return rep


# ---------------------------------------------------------------------------
# Apply items
# ---------------------------------------------------------------------------
def check_items(rows, items, d: int, s0: int = 0, where: str = "") -> list[Violation]:
    """One sorted list's apply items ``(m, 4)`` (first position, positions,
    first column, columns), positions offset by ``s0``: each (position,
    column < d) covered exactly once, and each (row, column) written by
    exactly one item (an item that starts or ends inside a run shares that
    row with its neighbour)."""
    rows = np.asarray(rows)
    items = np.asarray(items, dtype=np.int64).reshape(-1, 4)
    N = len(rows)
    out = []
    cover = np.zeros((N, d), dtype=np.int32)
    head = np.ones(N, dtype=bool)
    head[1:] = rows[1:] != rows[:-1]
    run = np.cumsum(head) - 1
    writers = np.zeros((int(run[-1]) + 1 if N else 0, d), dtype=np.int32)
    for q0, m, c0, width in items:
        q0 -= s0
        if q0 < 0 or q0 + m > N or m < 1:
            out.append(Violation("coverage", f"item at {q0 + s0}+{m} outside the list "
                                             f"[{s0}, {s0 + N})", where))
            continue
        c1 = min(c0 + width, d)
        cover[q0:q0 + m, c0:c1] += 1
        writers[np.unique(run[q0:q0 + m]), c0:c1] += 1
    if (writers > 1).any():
        r, c = np.argwhere(writers > 1)[0]
        out.append(Violation("two-writers", f"row {rows[np.flatnonzero(run == r)[0]]}, "
                                            f"column {c}: {writers[r, c]} items", where))
    if (cover != 1).any():
        q, c = np.argwhere(cover != 1)[0]
        out.append(Violation("coverage", f"position {q + s0} (row {rows[q]}), column {c} "
                                         f"written {cover[q, c]} times", where))
    return out


def _zipf_ids(n: int, B: int, V: int, K: int, seed: int):
    import torch

    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, V + 1)
    p /= p.sum()
    draw = lambda *s: torch.from_numpy(rng.choice(V, size=s, p=p).astype(np.int32))
    return draw(n, B), draw(n, B), draw(n, B, K)


def check_item_rules(cases=None, items_fn=None) -> ModelCheckReport:
    """Real ids → the port's item rules → :func:`check_items`. Each case
    ``(n, B, V, K, d, blk)`` of Zipf(1) ids: K2/K4a's items
    (``apply_items`` on each (block, table) list sorted stably, as the
    launch's sort leaves it; the 16-byte path, and the 4-byte path where d
    is not a multiple of 4) and K5/K6's (``chain_items`` on ``block_sorts``).
    ``items_fn(rows, d, vec4, s0)`` replaces K2/K4a's rule (the
    planted-fault tests)."""
    import torch

    from repro_torch.kernels.sgns_block_step import apply_items
    from repro_torch.kernels.sgns_fused_hbm import block_sorts
    from repro_torch.kernels.sgns_fused_pipe import chain_items

    items_fn = items_fn or (lambda rows, d, vec4, s0: apply_items(rows, d, vec4, s0=s0))
    cases = cases or ((2, 96, 40, 3, 48, 32), (1, 100, 30, 5, 50, 32), (2, 64, 2000, 5, 64, 64),
                      (1, 200, 8, 2, 16, 64))
    rep = ModelCheckReport()
    for n, B, V, K, d, blk in cases:
        cen, ctx, neg = _zipf_ids(n, B, V, K, seed=B + V)
        w_rows, _, c_rows, _ = block_sorts(cen, ctx, neg, blk, V)
        nblocks = -(-B // blk)
        for w, b, c_table in itertools.product(range(n), range(nblocks), (True, False)):
            nb = min(blk, B - b * blk)
            s0 = b * blk * (K + 1) if c_table else b * blk
            L = nb * (K + 1) if c_table else nb
            rows = (c_rows if c_table else w_rows)[w, s0:s0 + L].numpy()
            for vec4 in ((True, False) if d % 4 == 0 else (False,)):
                where = (f"n={n} B={B} V={V} K={K} d={d} blk={blk} worker {w} block {b} "
                         f"{'C' if c_table else 'W'} vec4={vec4}")
                rep.violations += check_items(rows, items_fn(rows, d, vec4, s0), d, s0,
                                              "K2/K4a " + where)
                rep.violations += check_items(rows, chain_items(rows, d, 4 if vec4 else 1, s0),
                                              d, s0, "K5/K6 " + where)
                rep.lists_checked += 2
    return rep


# ---------------------------------------------------------------------------
# The planner's hazard flags against an independent oracle (the reference's
# construction: every bounded pattern of window overlaps)
# ---------------------------------------------------------------------------
_W_BASE, _C_BASE, _N_BASE = 1000, 4000, 7000
_PLAN_V = 10_000
RING_DEPTHS = (2, 3, 4)


def _stream_ids(nblocks: int, blk: int, choices):
    """Ids realising an overlap pattern: ``choices[(b, m)]`` ∈ {0: none,
    1: a W row shared with block b − m, 2: a C row shared} (the shared row
    is always the target block's last pair's, never itself rewritten)."""
    cen = np.zeros((nblocks, blk), np.int32)
    ctx = np.zeros((nblocks, blk), np.int32)
    neg = np.zeros((nblocks, blk, 1), np.int32)
    for b in range(nblocks):
        for j in range(blk):
            cen[b, j] = _W_BASE + b * 100 + j
            ctx[b, j] = _C_BASE + b * 100 + j
            neg[b, j, 0] = _N_BASE + b * 100 + j
    for (b, m), choice in choices.items():
        j = m - 1
        if choice == 1:
            cen[b, j] = _W_BASE + (b - m) * 100 + (blk - 1)
        elif choice == 2:
            tgt = _C_BASE + (b - m) * 100 + (blk - 1)
            if (b + m) % 2:
                neg[b, j, 0] = tgt
            else:
                ctx[b, j] = tgt
    return cen.reshape(-1), ctx.reshape(-1), neg.reshape(-1, 1)


def _expected_hazards(c, x, ng, nblocks: int, blk: int, hot_rows: int, S: int) -> np.ndarray:
    """The oracle: per block the cold rows of each table (padding repeats
    the first pair), and a block's flag set when it shares a row of either
    table with one of the ``S - 1`` blocks before it."""
    def blocks(a):
        a = np.asarray(a).reshape(a.shape[0], -1)
        pad = nblocks * blk - a.shape[0]
        if pad:
            a = np.concatenate([a, np.repeat(a[:1], pad, axis=0)])
        return a.reshape(nblocks, blk, -1)

    cb, xb, nbk = blocks(c), blocks(x), blocks(ng)
    w_sets = [set(int(v) for v in cb[b].ravel() if v >= hot_rows) for b in range(nblocks)]
    c_sets = [set(int(v) for v in np.concatenate([xb[b].ravel(), nbk[b].ravel()])
                  if v >= hot_rows) for b in range(nblocks)]
    hz = np.zeros(nblocks, np.int32)
    for b in range(nblocks):
        for m in range(1, min(S, b + 1)):
            if w_sets[b] & w_sets[b - m] or c_sets[b] & c_sets[b - m]:
                hz[b] = 1
    return hz


def check_planner(ring_depths=RING_DEPTHS, max_nblocks: int = 4, plan_fn=None
                  ) -> ModelCheckReport:
    """``plan_blocks``' hazard flags against :func:`_expected_hazards` for
    every ring depth × block count × assignment of {none, W, C} overlaps to
    each (block, window offset), with a tail variant and a hot-tier case
    (one hot id shared by every block: no flag with the tier, every flag
    without it). ``plan_fn`` is injectable for the planted-fault tests."""
    import torch

    from repro_torch.kernels.sgns_fused_pipe import plan_blocks

    plan_fn = plan_fn or plan_blocks
    rep = ModelCheckReport()

    def one(cen, ctx, neg, blk, S, hot, where):
        B = len(cen)
        nblocks = -(-B // blk)
        plan = plan_fn(torch.from_numpy(cen)[None], torch.from_numpy(ctx)[None],
                       torch.from_numpy(neg)[None], _PLAN_V, blk, hot_rows=hot, ring_depth=S)
        got = plan.hazard[0].numpy()
        exp = _expected_hazards(cen, ctx, neg, nblocks, blk, hot, S)
        if not np.array_equal(got, exp):
            rep.violations.append(Violation(
                "war-hazard", f"planner hazards {list(got)} != look-behind oracle "
                              f"{list(exp)} (hot_rows={hot}, B={B})", where))
        rep.plans_checked += 1

    for S in ring_depths:
        blk = max(S, 3)
        for nblocks in range(1, max_nblocks + 1):
            slots = [(b, m) for b in range(1, nblocks) for m in range(1, min(S, b + 1))]
            tails = (0, 1) if nblocks >= 2 else (0,)
            for pattern in itertools.product((0, 1, 2), repeat=len(slots)):
                cen, ctx, neg = _stream_ids(nblocks, blk, dict(zip(slots, pattern)))
                for tail in tails:
                    B = nblocks * blk - tail
                    one(cen[:B], ctx[:B], neg[:B], blk, S, 0, f"S={S} nblocks={nblocks}")
            cen, ctx, neg = _stream_ids(nblocks, blk, {})
            ctx = ctx.copy()
            ctx[::blk] = 5                 # one hot id in every block's C set
            one(cen, ctx, neg, blk, S, 10, f"S={S} nblocks={nblocks} hot")
            one(cen, ctx, neg, blk, S, 0, f"S={S} nblocks={nblocks} hot id cold")
    return rep


# ---------------------------------------------------------------------------
# The card's timeline
# ---------------------------------------------------------------------------
#: ``stamps`` marks (``block_step_variants``): 1 a sort task's keys loaded,
#: 5 a drawing CTA's draw written (before its release); 8 + 4b block b's
#: pairs done, 9 + 4b past the barrier, 10 + 4b its applies done, 11 + 4b
#: past the barrier that ends it.
STAMP_DRAWN, STAMP_KEYS = 5, 1


def check_timeline(stamps: np.ndarray, geo: LaunchGeometry, where: str = "card"
                   ) -> list[Violation]:
    """Hold one launch's observed ``%globaltimer`` marks ``(ctas, 64)`` (ns;
    0: not stamped) to the model, group by group (each group one worker):
    every CTA's pass of block b's first barrier after every CTA's end of
    block b's pairs, its pass of the barrier that ends block b after every
    CTA's end of block b's applies, and each C list's sort loading its keys
    after every drawing CTA wrote its draw."""
    out = []
    s = stamps.astype(np.int64)
    G = geo.group_ctas
    first = geo.sorters if G > geo.sorters else 0
    for g in range(geo.groups):
        grp = s[g * G:(g + 1) * G]
        for b in range(geo.nblocks):
            pairs_end, past = grp[:, 8 + 4 * b], grp[:, 9 + 4 * b]
            if past.min() < pairs_end.max():
                out.append(Violation("block-order", f"group {g}: a CTA began block {b}'s "
                                     f"applies {(pairs_end.max() - past.min())} ns before "
                                     f"another ended its pairs", where))
            if b + 1 < geo.nblocks:
                applies_end, next_past = grp[:, 10 + 4 * b], grp[:, 11 + 4 * b]
                if next_past.min() < applies_end.max():
                    out.append(Violation("block-order", f"group {g}: a CTA passed the "
                                         f"barrier after block {b} before another ended its "
                                         f"applies", where))
        drawn = grp[first:, STAMP_DRAWN]
        c_sorters = [r for r in range(min(geo.sorters, G))
                     if any(t % 2 == 0 for t in range(r, 2 * geo.nblocks, geo.sorters))]
        keys = grp[c_sorters, STAMP_KEYS] if c_sorters else np.array([], np.int64)
        if len(keys) and (keys == 0).any() or (drawn == 0).any():
            out.append(Violation("draw-order", f"group {g}: a draw or sort left no mark",
                                 where))
        elif len(keys) and keys.min() < drawn.max():
            out.append(Violation("draw-order", f"group {g}: a C list's sort loaded its keys "
                                 f"{drawn.max() - keys.min()} ns before the last draw",
                                 where))
    return out


def model_timeline(geo: LaunchGeometry, events: list[Event] | None = None) -> np.ndarray:
    """The marks ``(ctas, 64)`` of one legal run of the model (each event at
    1 + the latest time of the events it must follow), in the ``stamps``
    variant's slots: what :func:`check_timeline` accepts, for its tests."""
    events = events or launch_schedule("block", geo.n, geo.nblocks, geo)
    anc = _happens_before(events)
    t = np.zeros(len(events), np.int64)
    # an event's ancestors have fewer ancestors than it: a topological order
    for i in sorted(range(len(events)), key=lambda i: anc[i].bit_count()):
        t[i] = 1 + max((t[p] for p in range(len(events)) if anc[i] >> p & 1), default=0)
    stamps = np.zeros((geo.groups * geo.group_ctas, 64), np.int64)
    state: dict[int, list] = {}          # cta -> [block, past its applies]
    for i, e in enumerate(events):
        if e.cta < 0:
            continue
        st = state.setdefault(e.cta, [0, False])
        if e.kind in ("draw", "sort", "pairs") and st[1]:
            st[:] = [e.block if e.block >= 0 else 0, False]     # the next worker
        if e.kind == "draw":
            stamps[e.cta, STAMP_DRAWN] = t[i]
        elif e.kind == "sort" and e.reads:
            stamps[e.cta, STAMP_KEYS] = t[i]
        elif e.kind == "arrive" and not st[1]:
            stamps[e.cta, 8 + 4 * st[0]] = t[i]
        elif e.kind == "wait":
            stamps[e.cta, (11 if st[1] else 9) + 4 * st[0]] = t[i]
            if st[1]:
                st[:] = [st[0] + 1, False]
        elif e.kind == "applies":
            stamps[e.cta, 10 + 4 * e.block] = t[i]
            st[:] = [e.block, True]
    return stamps


def run(max_nblocks: int = 6) -> ModelCheckReport:
    """The full pass: the launch space, the item rules, the planner."""
    rep = check_schedule_space(max_nblocks)
    rep.merge(check_item_rules())
    return rep.merge(check_planner())


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-nblocks", type=int, default=6,
                    help="block-count bound of the launch space (default 6)")
    args = ap.parse_args(argv)
    rep = run(args.max_nblocks)
    print(f"dma_model: {rep.summary()}")
    return 0 if rep.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
