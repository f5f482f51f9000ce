"""The port's block planner, schedule, K5/K6 plain versions and the
``@zipf50k`` workload against the JAX package.

* ``plan_blocks`` for n = 3 workers against ``jax.vmap`` of the
  reference's, every field bitwise, over hot tiers, ring depths and
  duplicate-heavy streams with a tail block; its hazards against the sets
  they stand for, and the kernel's apply order against a stable sort;
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
    flags at least what depth 2 flags (b against b - 1), the one ordering
    the kernels' two-slot ring needs."""
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


@pytest.mark.parametrize("table", ("W", "C"))
@pytest.mark.parametrize("hot_rows", (0, 1, 8, V))
def test_apply_order_is_a_stable_sort_by_block_and_target(hot_rows, table):
    """The kernels' apply lists: per block, the elements stably sorted by
    their update target (the slot, or ``slots + id`` for a hot id), so each
    target's addends form one run in reference order — W at centers; C at
    contexts, then at negatives."""
    c, x, neg = _ids(hot_rows + 3)
    plan = P.plan_blocks(torch.from_numpy(c), torch.from_numpy(x), torch.from_numpy(neg), V,
                         BLK, hot_rows=hot_rows)
    if table == "W":
        pos, ids, slots = plan.w_pos, plan.cen, plan.uw.shape[-1]
    else:
        pos = torch.cat([plan.cp_pos, plan.cn_pos], -1)
        ids = torch.cat([plan.ctx, plan.neg], -1)
        slots = plan.uc.shape[-1]
    tgt, el = P._apply_order(pos, ids, slots, hot_rows)
    L = pos.shape[-1]
    assert tgt.dtype == el.dtype == torch.int32 and tuple(tgt.shape) == (N, plan.nblocks * L)
    for w in range(N):
        for b in range(plan.nblocks):
            p, i = pos[w, b].numpy(), ids[w, b].numpy()
            target = np.where(i < hot_rows, slots + i, p)
            order = np.lexsort((np.arange(L), target))       # stable by target
            np.testing.assert_array_equal(tgt[w, b * L:(b + 1) * L].numpy(), target[order])
            np.testing.assert_array_equal(el[w, b * L:(b + 1) * L].numpy(), order)


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
