"""K2's and K4a's shared launch, what the CPU can check of it: the draw it
makes inside itself (its counters against K1's draw and the reference's),
the in-launch sort's order (a plain mirror of its radix passes, here)
against ``block_sorts`` and the reference's planner, the apply's item rule,
and the launch geometry (``kernels/sgns_block_step.py``). The kernel itself
runs only on the card (``test_torch_cuda.py``, which also holds its sort
bitwise against ``block_sorts`` and its draw against K1's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import sgns_fused_pipe as JP
from repro.kernels.sgns_fused import fused_negative_ids
from repro_torch.analysis import block_step_variants as V
from repro_torch.core.distributions import build_alias_table
from repro_torch.kernels import build
from repro_torch.kernels import sgns_block_step as S
from repro_torch.kernels import sgns_fused as K1
from repro_torch.kernels import sgns_fused_hbm as H

NEG = 5
# (n, V, B, blk): one block (blk >= B), a tail block (45 = 16 + 16 + 13),
# three workers, and a vocabulary so wide that block count * V >= 2**31
# (the reference's (block, row) keys need 64 bits; the in-launch sort takes
# eight 4-bit passes).
SORT_CASES = {"one-block": (3, 96, 45, 64), "tail": (3, 96, 45, 16),
              "n3-zipf": (3, 1000, 300, 128), "wide-V": (2, 2**30, 40, 16)}


def _ids(seed, n, V, B, K=NEG):
    """Zipf-heavy ids: long runs of the first rows, runs across blocks, a
    context that is also a negative."""
    rng = np.random.default_rng(seed)
    draw = lambda shape: ((rng.zipf(1.3, shape) - 1) % V).astype(np.int32)
    c, x, neg = draw((n, B)), draw((n, B)), draw((n, B, K))
    c[:, 3:9] = 5
    x[:, 10:20] = 5
    neg[:, 14:18, 0] = 5
    return torch.from_numpy(c), torch.from_numpy(x), torch.from_numpy(neg)


def _draw_inputs(n: int, V: int, seed: int = 3):
    """A Zipf(1.1) alias table a worker (each its own), the workers' JAX
    keys and their seed tensor."""
    rng = np.random.default_rng(seed)
    prob, alias = [], []
    for _ in range(n):
        p = 1.0 / np.arange(1, V + 1) ** 1.1
        prob_w, alias_w = build_alias_table(rng.permutation(p) / p.sum())
        prob.append(np.asarray(prob_w, np.float32))
        alias.append(np.asarray(alias_w, np.int32))
    table = {"prob": torch.from_numpy(np.stack(prob)), "alias": torch.from_numpy(np.stack(alias))}
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))
    return table, keys, K1.seed_tensor(keys)


@pytest.mark.parametrize("B, blk", ((45, 64), (45, 16), (300, 128)))
def test_folded_draw_counters_are_k1s_and_the_references(B, blk):
    """The launch draws negative k of pair p at counter p·K + k (a pair
    warp: (p0 + j)·K + lane; the draw pass: i = p·K + k, which a sort task
    reads at index_of(e) − B = p0·K + (e − nb)), under each worker's own
    seed and table: for n = 3 workers, bitwise K1's plain draw and the
    reference's ``fused_negative_ids``, block by block."""
    n, Vv = 3, 500
    table, keys, seeds = _draw_inputs(n, Vv)
    k1 = K1.sample_negatives_plain(seeds, table["prob"], table["alias"], (B, NEG))
    pairs = torch.arange(B, dtype=torch.int64)[:, None] * NEG + torch.arange(NEG)
    warps = K1.alias_draw_from_counters(seeds, table["prob"], table["alias"],
                                        pairs.expand(n, B, NEG))
    assert warps.dtype == torch.int32 and torch.equal(warps, k1)
    for w in range(n):
        ref = fused_negative_ids(jnp.asarray(keys[w]), jnp.asarray(table["prob"][w].numpy()),
                                 jnp.asarray(table["alias"][w].numpy()), (B, NEG))
        np.testing.assert_array_equal(k1[w].numpy(), np.asarray(ref))
    blk = H.pick_block_pairs(B, blk)
    ctx = torch.zeros((n, B), dtype=torch.int32)
    for b in range(-(-B // blk)):
        p0 = b * blk
        nb = min(blk, B - p0)
        rows = S.list_rows(ctx, ctx, table, seeds, NEG, blk, b, c_table=True)
        assert torch.equal(rows[:, nb:].reshape(n, nb, NEG), k1[:, p0:p0 + nb])


@pytest.mark.parametrize("c_table", (True, False), ids=("C", "W"))
@pytest.mark.parametrize("case", ("one-block", "tail"))
def test_sort_lists_from_counters_equal_the_lists_from_k1s_ids(case, c_table):
    """A sort task's list, its negatives drawn from their counters
    (``list_rows``), is the list built from K1's ids of the step (C: the
    block's contexts, then its K negatives a pair; W: its centers), for
    every block of a tail-block batch and of one block (blk ≥ B); and the
    in-launch sort of those lists is ``block_sorts`` on K1's ids."""
    n, Vv, B, blk = SORT_CASES[case]
    table, _, seeds = _draw_inputs(n, Vv, seed=5)
    c, x, _ = _ids(len(case), n, Vv, B)
    ids = K1.sample_negatives_plain(seeds, table["prob"], table["alias"], (B, NEG))
    blk = H.pick_block_pairs(B, blk)
    for b in range(-(-B // blk)):
        p0 = b * blk
        nb = min(blk, B - p0)
        got = S.list_rows(c, x, table, seeds, NEG, blk, b, c_table)
        want = (torch.cat([x[:, p0:p0 + nb], ids[:, p0:p0 + nb].reshape(n, -1)], 1)
                if c_table else c[:, p0:p0 + nb])
        assert got.dtype == torch.int32 and torch.equal(got, want)
    for g, r in zip(_block_sorts_in_launch(c, x, ids, blk, Vv), H.block_sorts(c, x, ids, blk, Vv)):
        assert torch.equal(g, r)


RADIX_BITS = 4             # the in-launch sort's digit (kRadixBits)


def _radix_passes(V: int) -> int:
    """The in-launch sort's passes for rows in ``[0, V)``: one a 4-bit
    digit of ``V - 1``."""
    return -(-max(1, (V - 1).bit_length()) // RADIX_BITS)


def _block_sorts_in_launch(centers, contexts, ids, blk: int, V: int):
    """The in-launch sort's output, computed as the kernel computes it: per
    worker, block of ``blk`` pairs and table, the list's rows in element
    order (C: the block's contexts, then its negatives; W: its centers),
    sorted by :func:`_radix_passes` passes of 4-bit digits, least
    significant first, each stable; then each entry's row and index (into
    ``concat(contexts, ids)`` for C, the pair for W). Returns ``(w_rows,
    w_perm, c_rows, c_perm)`` in ``block_sorts``' layout and types."""
    n, B = centers.shape
    K = ids.shape[-1]
    flat = torch.cat([contexts, ids.reshape(n, B * K)], 1).to(torch.int64)
    out = {"W": ([], []), "C": ([], [])}
    for p0 in range(0, B, blk):
        nb = min(blk, B - p0)
        pw = torch.arange(p0, p0 + nb)
        pc = torch.cat([pw, B + torch.arange(p0 * K, (p0 + nb) * K)])
        for name, rows, index in (("W", centers[:, pw].to(torch.int64), pw),
                                  ("C", flat[:, pc], pc)):
            order = torch.arange(len(index)).expand_as(rows)
            for k in range(_radix_passes(V)):
                digit = torch.gather(rows, 1, order) >> (RADIX_BITS * k) & (2**RADIX_BITS - 1)
                order = torch.gather(order, 1, torch.sort(digit, dim=1, stable=True).indices)
            out[name][0].append(torch.gather(rows, 1, order))
            out[name][1].append(index[order])
    (w_rows, w_perm), (c_rows, c_perm) = (
        (torch.cat(r, 1).to(torch.int32), torch.cat(i, 1)) for r, i in (out["W"], out["C"]))
    return w_rows, w_perm, c_rows, c_perm


@pytest.mark.parametrize("case", sorted(SORT_CASES))
def test_in_launch_sort_bitwise_equals_block_sorts(case):
    n, V, B, blk = SORT_CASES[case]
    c, x, neg = _ids(len(case), n, V, B)
    blk = H.pick_block_pairs(B, blk)
    got = _block_sorts_in_launch(c, x, neg, blk, V)
    want = H.block_sorts(c, x, neg, blk, V)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert torch.equal(g, r)
    assert _radix_passes(V) == {"one-block": 2, "tail": 2, "n3-zipf": 3, "wide-V": 8}[case]
    if case == "wide-V":
        assert -(-B // blk) * V >= 2**31


@pytest.mark.parametrize("case", ("one-block", "tail", "n3-zipf"))
def test_in_launch_sort_runs_match_the_reference_plan(case):
    """Per worker, block and table, against ``jax.vmap`` of the reference's
    ``plan_blocks``: the runs' rows are the plan's valid unique rows (a
    tail block's may also hold rows only its padding brings), and each
    row's addends come in the order of the reference's apply (elements in
    blocked order)."""
    n, V, B, blk = SORT_CASES[case]
    c, x, neg = _ids(7 + len(case), n, V, B)
    blk = H.pick_block_pairs(B, blk)
    plan = jax.vmap(lambda a, b, m: JP.plan_blocks(a, b, m, V, blk))(c.numpy(), x.numpy(),
                                                                      neg.numpy())
    w_rows, w_perm, c_rows, c_perm = (t.numpy() for t in
                                      _block_sorts_in_launch(c, x, neg, blk, V))
    nblocks = -(-B // blk)
    for w in range(n):
        for b in range(nblocks):
            p0 = b * blk
            nv = min(blk, B - p0)
            for table in ("W", "C"):
                if table == "W":
                    rows = w_rows[w, p0:p0 + nv]
                    el = w_perm[w, p0:p0 + nv] - p0
                    ids = np.asarray(plan.cen[w, b])
                    u, count = np.asarray(plan.uw[w, b]), int(plan.n_w[w, b])
                else:
                    s0, s1 = p0 * (NEG + 1), (p0 + nv) * (NEG + 1)
                    rows, xx = c_rows[w, s0:s1], c_perm[w, s0:s1]
                    el = np.where(xx < B, xx - p0, blk + xx - B - p0 * NEG)
                    ids = np.concatenate([np.asarray(plan.ctx[w, b]),
                                          np.asarray(plan.neg[w, b]).reshape(-1)])
                    u, count = np.asarray(plan.uc[w, b]), int(plan.n_c[w, b])
                np.testing.assert_array_equal(ids[el], rows)
                heads = np.unique(rows)
                valid = set(u[:count].tolist())
                assert set(heads.tolist()) <= valid
                if nv == blk:
                    assert set(heads.tolist()) == valid, (w, b, table)
                order = np.lexsort((el, rows))
                np.testing.assert_array_equal(order, np.arange(len(rows)))


def _runs(rows):
    """(start, end) of each run of equal rows."""
    starts = [0] + [q for q in range(1, len(rows)) if rows[q] != rows[q - 1]]
    return list(zip(starts, starts[1:] + [len(rows)]))


@pytest.mark.parametrize("split", (1, 8, 32, 1 << 30))
@pytest.mark.parametrize("d,vec4", ((48, True), (50, False), (500, True), (500, False)))
def test_apply_items_cover_each_run_once_in_list_order(d, vec4, split):
    """Every (position, column) of the list exactly once; items of whole
    runs in ascending position (so ascending row) order; a run of at least
    ``split`` addends alone in chunks of 32 columns (on the 16-byte path),
    the shorter ones in chunks of 128 (32 on the scalar path) grouped by
    the window of 32 positions their heads lie in; each run's addends in
    pair order."""
    c, x, neg = _ids(split % 97 + d, 1, 400, 600)
    blk = 256
    _, _, c_rows, c_perm = _block_sorts_in_launch(c, x, neg, blk, 400)
    s0, s1 = blk * (NEG + 1), 2 * blk * (NEG + 1)      # block 1's C list
    rows, perm = c_rows[0, s0:s1].numpy(), c_perm[0, s0:s1].numpy()
    items = S.apply_items(rows, d, vec4, split, s0=s0)
    runs = _runs(rows)
    assert max(e - s for s, e in runs) >= 32            # Zipf-hot runs exist
    cover = np.zeros((len(rows), d), dtype=np.int64)
    heads = {s for s, _ in runs}
    ends = {e for _, e in runs}
    long_runs = {s for s, e in runs if e - s >= split} if vec4 else set()
    prev = -1
    for q, length, col0, width in items.tolist():
        q -= s0
        assert q >= prev                                # list order
        prev = q
        assert q in heads and q + length in ends        # whole runs
        cover[q:q + length, col0:min(col0 + width, d)] += 1
        if q in long_runs:
            assert (q, q + length) in runs and width == 32
        else:
            assert width == (128 if vec4 else 32)
            inner = [s for s in heads if q <= s < q + length]
            assert not long_runs & set(inner)
            assert len({s // 32 for s in inner}) == 1   # heads share a window
    assert (cover == 1).all()
    for s, e in runs:                                   # pair order within a run
        assert (np.diff(perm[s:e]) > 0).all()
        assert len(set(rows[s:e])) == 1


def test_apply_items_of_a_vocabulary_of_eight_rows():
    """Eight rows: every run is long at split 32, so the list is eight
    items' worth of narrow chunks; at split 2**30 the windows group them."""
    rows = np.repeat(np.arange(8), 200)
    long = S.apply_items(rows, 500, True, 32)
    assert len(long) == 8 * 16 and set(long[:, 3]) == {32}
    assert sorted(set(long[:, 0])) == list(range(0, 1600, 200))
    short = S.apply_items(rows, 500, True, 1 << 30)
    assert set(short[:, 3]) == {128}
    assert len(short) == 4 * len({(s // 32) for s in range(0, 1600, 200)})


@pytest.mark.parametrize("d", (48, 50, 500, 512))
@pytest.mark.parametrize("n", (1, 10, 40))
def test_launch_geometry_fits_two_ctas_an_sm(n, d):
    """Groups, CTAs a group and shared memory a CTA on an H100 (132 SMs):
    two CTAs fit each SM's 228 KB (a CTA may take 227 KB; 1 KB a CTA is
    the system's), the grid fits the card, every worker has a group, a
    pair's K + 2 rows fit a warp's region, and the sorting CTAs leave the
    first block's pairs to the others."""
    vec4 = d % 4 == 0
    for B, blk in ((1024, 1024), (1024, 256), (300, 128)):
        g = S.geometry(n, d, B, NEG, blk, sms=132, vec4=vec4)
        per_cta = S.SMEM_BYTES + S.STATIC_SMEM_BYTES
        assert per_cta <= 227 * 1024
        assert S.CTAS_PER_SM * (per_cta + 1024) <= 228 * 1024
        assert 1 <= g.groups <= n and g.groups * g.group_ctas <= S.CTAS_PER_SM * 132
        assert g.group_ctas >= min(S.MIN_GROUP, S.CTAS_PER_SM * 132)
        assert 1 <= g.sorters <= 2 * g.nblocks
        assert g.sorters < g.group_ctas
        assert g.nblocks == -(-B // blk) and g.blk == min(blk, B)
        assert (NEG + 2) * d * 4 <= S.WARP_BYTES
    main = S.geometry(10, 500, 1024, NEG, 1024, sms=132)
    assert (main.groups, main.group_ctas, main.sorters) == (10, 26, 2)


@pytest.mark.parametrize("name", sorted(V.VARIANTS))
def test_block_step_variant_patches_apply(name):
    """``analysis/block_step_variants.py`` times patched copies of the
    launch on the card; each patch must still find the code it changes,
    and the per-lane copy variants bring the 16-byte copy the kernel no
    longer has."""
    text = V.patched_header(name)
    base = (build.CSRC / V.HEADER).read_text()
    assert (text == base) == (name == "base")
    assert ("copy16(" in text) == name.startswith("lsu-")
    assert "copy16(" not in base and "kSplitRuns = 32;" in base
    if name.startswith("split") or name.endswith("nosplit"):
        assert "kSplitRuns = 32;" not in text
