"""The port's block planner, schedule, K5/K6 plain versions and the
``@zipf50k`` workload against the JAX package.

* ``plan_blocks`` for n = 3 workers against ``jax.vmap`` of the
  reference's, every field bitwise, over hot tiers, ring depths and
  duplicate-heavy streams with a tail block; its hazards against the sets
  they stand for;
* the card path's block sorts tied to the plan (run heads = unique rows,
  each row's addend order = the reference's apply order), and the
  kernel's plain mirror (runs applied in place) bitwise the ring-based
  plain version;
* ``zipf50k_ids`` bitwise, and the planner's row traffic at ``@zipf50k``;
* the plain K5/K6 steps against ``sgns_fused_pipe_step`` /
  ``sgns_fused_tiered_step(interpret=True)`` per worker (tables atol 1e-6,
  mean loss rtol 1e-5: the port and XLA sum the dot products in different
  orders), and bitwise against the plain K4a at every ring depth and hot
  tier (the same gathered values, the same addends in the same order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.workloads import zipf50k_ids as j_zipf50k_ids
from repro.data.pairs import stack_noise_tables as j_stack_tables
from repro.kernels import sgns_fused_pipe as JP
from repro.kernels.sgns_fused_tiered import sgns_fused_tiered_step as j_tiered_step
from repro_torch import convert
from repro_torch.analysis.workloads import ZIPF50K, zipf50k_ids, zipf50k_row_traffic
from repro_torch.kernels import sgns_fused as K
from repro_torch.kernels import sgns_fused_hbm as H
from repro_torch.kernels import sgns_fused_pipe as P
from repro_torch.kernels import sgns_fused_tiered as T

TABLE_ATOL = 1e-6
LOSS_RTOL = 1e-5
N, V, D, B, NEG, BLK = 3, 96, 12, 45, 5, 16    # 3 blocks: 16, 16 and a tail of 13


def _ids(seed, V=V, B=B, K=NEG, dup=True):
    """Zipf-heavy ids of n workers; with ``dup``, runs of one row inside
    and across blocks (repeated centers, a context that is also a
    negative)."""
    rng = np.random.default_rng(seed)
    c = (rng.zipf(1.4, (N, B)) % V).astype(np.int32)
    x = (rng.zipf(1.4, (N, B)) % V).astype(np.int32)
    neg = (rng.zipf(1.4, (N, B, K)) % V).astype(np.int32)
    if dup:
        c[:, 3:9] = 5
        x[:, 10:20] = 5
        neg[:, 14:18, 0] = 5
    return c, x, neg


# ------------------------------------------------------------------ planner
@pytest.mark.parametrize("ring_depth", (2, 3, 4))
@pytest.mark.parametrize("hot_rows", (0, 1, 8, V))
def test_plan_blocks_bitwise_vs_vmapped_reference(hot_rows, ring_depth):
    c, x, neg = _ids(hot_rows + 10 * ring_depth)
    ref = jax.vmap(lambda a, b, n: JP.plan_blocks(a, b, n, V, BLK, hot_rows=hot_rows,
                                                  ring_depth=ring_depth))(c, x, neg)
    got = P.plan_blocks(torch.from_numpy(c), torch.from_numpy(x), torch.from_numpy(neg), V,
                        BLK, hot_rows=hot_rows, ring_depth=ring_depth)
    assert set(got._fields) == set(ref._fields) - {"mask"}
    for f in got._fields:
        r, g = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert g.dtype == r.dtype and g.shape == r.shape, f
        np.testing.assert_array_equal(g, r, err_msg=f)
    # the reference's pair mask is the kernels' rule: pair index < B
    np.testing.assert_array_equal(np.asarray(ref.mask).reshape(N, -1),
                                  np.broadcast_to(np.arange(3 * BLK) < B, (N, 3 * BLK)))
    assert (got.nblocks, got.block_pairs) == (3, BLK)
    if hot_rows == V:
        assert int(got.n_w.sum() + got.n_c.sum()) == 0 and not got.hazard.any()
    if hot_rows == 0:
        assert got.hazard.any()          # the repeated row 5 spans blocks


def test_plan_pads_with_the_first_pair_and_counts_its_rows():
    """The tail block is padded with each worker's first pair: its rows
    join the tail's unique sets (and so the traffic), though they update
    nothing."""
    c, x, neg = _ids(1, dup=False)
    plan = P.plan_blocks(torch.from_numpy(c), torch.from_numpy(x), torch.from_numpy(neg),
                         V, BLK)
    assert torch.equal(plan.cen[:, -1, B - 2 * BLK:],
                       torch.from_numpy(c[:, :1]).expand(N, 3 * BLK - B))
    for w in range(N):
        tail = plan.uw[w, -1, :int(plan.n_w[w, -1])]
        assert int(c[w, 0]) in tail.tolist()
    traffic = P.plan_row_traffic(plan)
    assert traffic == 2 * int(plan.n_w.sum() + plan.n_c.sum())
    assert P.plan_row_traffic(plan, hot_rows=4) == traffic + 4 * 4 * N


def _cold_sets(plan, hot_rows):
    """Each worker's and block's cold touched rows, per table, from the
    blocked ids."""
    n, nb = plan.n_w.shape
    cw, cc = [], []
    for w in range(n):
        cw.append([set(plan.cen[w, b].tolist()) for b in range(nb)])
        cc.append([set(plan.ctx[w, b].tolist()) | set(plan.neg[w, b].tolist())
                   for b in range(nb)])
    cold = lambda s: {i for i in s if i >= hot_rows}
    return ([[cold(s) for s in r] for r in cw], [[cold(s) for s in r] for r in cc])


@pytest.mark.parametrize("ring_depth", (2, 3, 4))
@pytest.mark.parametrize("hot_rows", (0, 1, 8, V))
def test_hazards_flag_cold_rows_met_in_the_look_behind(hot_rows, ring_depth):
    """``hazard[b]`` is set iff block b's cold rows meet those of one of the
    previous ``ring_depth - 1`` blocks in the same table. So every depth
    flags at least what depth 2 flags (b against b - 1)."""
    c, x, neg = _ids(hot_rows + ring_depth)
    args = (torch.from_numpy(c), torch.from_numpy(x), torch.from_numpy(neg), V, BLK)
    plan = P.plan_blocks(*args, hot_rows=hot_rows, ring_depth=ring_depth)
    two = P.plan_blocks(*args, hot_rows=hot_rows, ring_depth=2)
    sw, sc = _cold_sets(plan, hot_rows)
    for w in range(N):
        for b in range(plan.nblocks):
            want = any(sw[w][b] & sw[w][j] or sc[w][b] & sc[w][j]
                       for j in range(max(0, b - ring_depth + 1), b))
            assert bool(plan.hazard[w, b]) == want, (w, b)
    assert bool((plan.hazard >= two.hazard).all())


def _table_view(plan, runs, table, w, b, blk):
    """One worker's and block's apply list of ``table``, both ways: the
    card path's sorted runs ``(rows, elements)`` — an element is its index
    in the plan's blocked order (W: pair j; C: context j, or ``blk + j·K +
    k``) — and the plan's ``(pos, ids, u, count, real)``: each element's
    slot, its id, the unique cold rows, their count, and which elements
    belong to real pairs (not the tail's padding)."""
    w_keys, w_perm, c_keys, c_perm = (t[w].numpy() for t in runs)
    p0 = b * blk
    nv = min(blk, B - p0)
    if table == "W":
        rows, el = w_keys[p0:p0 + nv], w_perm[p0:p0 + nv] - p0
        pos, ids, u, count = plan.w_pos[w, b], plan.cen[w, b], plan.uw[w, b], plan.n_w[w, b]
        real = np.arange(blk) < nv
    else:
        s0, s1 = p0 * (NEG + 1), (p0 + nv) * (NEG + 1)
        rows, x = c_keys[s0:s1], c_perm[s0:s1]
        el = np.where(x < B, x - p0, blk + x - B - p0 * NEG)
        pos = torch.cat([plan.cp_pos[w, b], plan.cn_pos[w, b]])
        ids = torch.cat([plan.ctx[w, b], plan.neg[w, b]])
        u, count = plan.uc[w, b], plan.n_c[w, b]
        e = np.arange(blk * (NEG + 1))
        real = np.where(e < blk, e < nv, e - blk < nv * NEG)
    return rows, el, pos.numpy(), ids.numpy(), u.numpy(), int(count), real


@pytest.mark.parametrize("block_pairs", (BLK, 64), ids=("tail", "one-block"))
@pytest.mark.parametrize("ring_depth", (2, 3, 4))
@pytest.mark.parametrize("hot_rows", (0, 1, 8, V))
def test_block_runs_match_the_reference_plan(hot_rows, ring_depth, block_pairs):
    """The card path's inputs (K4a's stable (block, row) sorts) against the
    reference's planner, per worker, block and table: the runs are sorted
    by row with each run's elements in order; their cold heads are the
    plan's valid unique rows (the tail block's unique sets may also hold
    rows only its padding brings); and each row's addends come in the
    order of the reference's apply, a stable sort of the elements by
    their update target (slot, or ``slots + id`` for a hot id)."""
    c, x, neg = (torch.from_numpy(a) for a in _ids(hot_rows + 10 * ring_depth + block_pairs))
    plan = P.plan_blocks(c, x, neg, V, block_pairs, hot_rows=hot_rows, ring_depth=ring_depth)
    blk = H.pick_block_pairs(B, block_pairs)
    runs = H.block_sorts(c, x, neg, blk, V)
    assert plan.block_pairs == blk and plan.nblocks == -(-B // blk)
    assert runs[0].dtype == runs[2].dtype == torch.int32
    assert runs[1].dtype == runs[3].dtype == torch.int64
    for w in range(N):
        for b in range(plan.nblocks):
            for table in ("W", "C"):
                rows, el, pos, ids, u, count, real = _table_view(plan, runs, table, w, b, blk)
                np.testing.assert_array_equal(ids[el], rows)        # each entry's row
                assert sorted(el.tolist()) == np.flatnonzero(real).tolist()
                order = np.lexsort((el, rows))
                np.testing.assert_array_equal(order, np.arange(len(rows)))
                heads = np.unique(rows)
                cold = heads[heads >= hot_rows]
                valid = u[:count]
                assert set(cold) <= set(valid)
                assert set(valid) - set(cold) <= set(ids[~real]), (w, b, table)
                slots = len(u)
                target = np.where(ids < hot_rows, slots + ids, pos)
                ref = np.lexsort((np.arange(len(ids)), target))
                row_of = np.where(target >= slots, target - slots,
                                  u[np.minimum(target, slots - 1)])
                want, got = {}, {}
                for e in ref[real[ref]]:
                    want.setdefault(int(row_of[e]), []).append(int(e))
                for r, e in zip(rows, el):
                    got.setdefault(int(r), []).append(int(e))
                assert got == want, (w, b, table)


@pytest.mark.parametrize("block_pairs", (BLK, 64), ids=("tail", "one-block"))
@pytest.mark.parametrize("hot_rows", (0, 1, 8, V))
def test_chain_plain_bitwise_equals_ring_plain(world, hot_rows, block_pairs):
    """``run_chain_plain`` — the kernel's algorithm, the sorted runs
    applied to the rows in place — against the reference's ring-based
    ``run_plan_plain`` on the same draw: tables and loss bitwise equal."""
    c, x = torch.from_numpy(world["c"]), torch.from_numpy(world["x"])
    table = convert.from_jax_table(world["table"])
    ids = K.sample_negatives_plain(K.seed_tensor(world["keys"]), table["prob"],
                                   table["alias"], (B, NEG))
    blk = H.pick_block_pairs(B, block_pairs)
    ring = {k: torch.from_numpy(world[k].copy()) for k in ("W", "C")}
    plan = P.plan_blocks(c, x, ids, V, blk, hot_rows=hot_rows)
    ring_loss = P.run_plan_plain(ring, plan, 0.05, B, hot_rows=hot_rows)
    chain = {k: torch.from_numpy(world[k].copy()) for k in ("W", "C")}
    chain_loss = P.run_chain_plain(chain, c, x, ids, H.block_sorts(c, x, ids, blk, V), 0.05,
                                   blk)
    assert torch.equal(chain_loss, ring_loss)
    for k in ("W", "C"):
        assert torch.equal(chain[k], ring[k])
        assert not torch.equal(chain[k], torch.from_numpy(world[k]))


# ------------------------------------------------------------------ zipf50k
def test_zipf50k_ids_bitwise_vs_reference():
    c, x, neg, table, seeds = zipf50k_ids("cpu")
    jc, jx, jneg, jt, jkey = j_zipf50k_ids()
    assert tuple(c.shape) == (1, ZIPF50K["B"])
    assert tuple(neg.shape) == (1, ZIPF50K["B"], ZIPF50K["K"])
    for got, ref in ((c, jc), (x, jx), (neg, jneg), (table["prob"], jt["prob"]),
                     (table["alias"], jt["alias"])):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref))
    np.testing.assert_array_equal(seeds[0].numpy().view(np.uint32), np.asarray(jkey))


def test_zipf50k_row_traffic():
    """The planner's row transfers a step at ``@zipf50k`` (the reference
    counts 91,386 and 59,692; ``repro.analysis.workloads``)."""
    assert zipf50k_row_traffic(0, device="cpu") == 91_386
    assert zipf50k_row_traffic(ZIPF50K["HOT"], device="cpu") == 59_692


# ------------------------------------------------------------------ steps
@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    counts = [rng.zipf(1.3, V).astype(np.float64) for _ in range(N)]
    table = j_stack_tables(counts, kind="alias")
    W = (0.1 * rng.normal(size=(N, V, D))).astype(np.float32)
    C = (0.1 * rng.normal(size=(N, V, D))).astype(np.float32)
    c, x, _ = _ids(7)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(5), N))
    return dict(table={k: np.asarray(v) for k, v in table.items()}, W=W, C=C, c=c, x=x,
                keys=keys)


def _run(world, step, **kw):
    p = {k: torch.from_numpy(world[k].copy()) for k in ("W", "C")}
    return step(p, torch.from_numpy(world["c"]), torch.from_numpy(world["x"]),
                convert.from_jax_table(world["table"]), K.seed_tensor(world["keys"]), 0.05,
                negatives=NEG, block_pairs=BLK, **kw)


@pytest.mark.parametrize("hot_rows,ring_depth", ((None, 2), (None, 3), (8, 2)),
                         ids=("pipe-ring2", "pipe-ring3", "tiered-hot8"))
def test_plain_matches_reference_kernel_in_interpret_mode(world, hot_rows, ring_depth):
    """K5/K6's plain versions (all workers at once) against the
    reference's interpret-mode kernels run per worker with the same key."""
    if hot_rows is None:
        tp, tloss, ids = _run(world, P.sgns_fused_pipe_step, ring_depth=ring_depth)
    else:
        tp, tloss, ids = _run(world, T.sgns_fused_tiered_step, ring_depth=ring_depth,
                              hot_rows=hot_rows)
    assert tuple(tloss.shape) == (N, B) and tuple(ids.shape) == (N, B, NEG)
    for w in range(N):
        jt = {k: jnp.asarray(v[w]) for k, v in world["table"].items()}
        args = ({k: jnp.asarray(world[k][w]) for k in ("W", "C")}, jnp.asarray(world["c"][w]),
                jnp.asarray(world["x"][w]), jt, jnp.asarray(world["keys"][w]),
                jnp.float32(0.05))
        kw = dict(negatives=NEG, block_pairs=BLK, ring_depth=ring_depth, interpret=True)
        if hot_rows is None:
            jp, jloss = JP.sgns_fused_pipe_step(*args, **kw)
        else:
            jp, jloss = j_tiered_step(*args, hot_rows=hot_rows, **kw)
        for k in ("W", "C"):
            np.testing.assert_allclose(tp[k][w].numpy(), np.asarray(jp[k]), rtol=0,
                                       atol=TABLE_ATOL)
        np.testing.assert_allclose(float(tloss[w].mean()), float(jloss), rtol=LOSS_RTOL)


@pytest.mark.parametrize("ring_depth", (2, 3, 4))
def test_plain_pipe_bitwise_equals_plain_hbm(world, ring_depth):
    hp, hloss, hids = _run(world, H.sgns_fused_hbm_step)
    pp, ploss, pids = _run(world, P.sgns_fused_pipe_step, ring_depth=ring_depth)
    assert torch.equal(pids, hids) and torch.equal(ploss, hloss)
    for k in ("W", "C"):
        assert torch.equal(pp[k], hp[k])
        assert not torch.equal(pp[k], torch.from_numpy(world[k]))


@pytest.mark.parametrize("hot_rows", (0, 1, 8, 40, V, V + 7))
def test_plain_tiered_bitwise_equals_plain_pipe(world, hot_rows):
    """Every row is served by exactly one tier with the same addends in the
    same order, so each hot tier gives K5's bits (``hot_rows`` above V
    clamps to V)."""
    pp, ploss, _ = _run(world, P.sgns_fused_pipe_step)
    K.reset_launch_counts()
    tp, tloss, _ = _run(world, T.sgns_fused_tiered_step, hot_rows=hot_rows)
    assert all(v == 0 for v in K.LAUNCHES.values())     # CPU: plain versions
    assert torch.equal(tloss, ploss)
    for k in ("W", "C"):
        assert torch.equal(tp[k], pp[k])


def test_pipe_wrappers_check_their_inputs(world):
    p = {k: torch.from_numpy(world[k].copy()) for k in ("W", "C")}
    c, x = torch.from_numpy(world["c"]), torch.from_numpy(world["x"])
    table = convert.from_jax_table(world["table"])
    seeds = K.seed_tensor(world["keys"])
    for step in (P.sgns_fused_pipe_step, T.sgns_fused_tiered_step):
        with pytest.raises(ValueError, match="ring_depth"):
            step(p, c, x, table, seeds, 0.05, ring_depth=1)
        with pytest.raises(ValueError, match="block_pairs"):
            step(p, c, x, table, seeds, 0.05, block_pairs=0)
        with pytest.raises(ValueError, match="negatives"):
            step(p, c, x, table, seeds, 0.05, negatives=K.MAX_NEGATIVES + 1)
        with pytest.raises(TypeError, match="contexts"):
            step(p, c, x.long(), table, seeds, 0.05)
        meta = {k: v.to("meta") for k, v in p.items()}
        with pytest.raises(ValueError, match="no kernel"):
            step(meta, c.to("meta"), x.to("meta"), {k: v.to("meta") for k, v in table.items()},
                 seeds.to("meta"), 0.05)
