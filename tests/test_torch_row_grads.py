"""K3's ring kernel, what the CPU can check of it (``kernels/sgns_update.py``):
the stage layout (``ring_shape``) and the tile schedule with its alignment
rule (``tile_plan``) — every pair covered once and in order, each span
copied by one bulk copy exactly where its address and size are 16-byte
multiples, else by 4-byte copies. The kernel itself runs only on the card
(``test_torch_cuda.py``: against its plain version and bitwise against its
first design)."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import sgns_update as U

NEG = 5
P = U.TILE_PAIRS
SMS = 132                      # an H100's SMs


def test_ring_shape_at_the_random_paths_width():
    """d = 500, K = 5: a pair's 7 rows are 14,000 B, so a stage of 8 pairs
    is 112,000 B and two stages take 224,128 B with the barriers: one CTA
    an SM. Rows too long for two stages of one pair are read in place."""
    r = U.ring_shape(500, NEG)
    assert (r.tile, r.cp_off, r.cn_off, r.stage_bytes) == (8, 16000, 32000, 112000)
    assert r.smem_bytes == U.BAR_BYTES + 2 * 112000 <= U.SMEM_OPTIN
    assert 2 * r.smem_bytes > U.SMEM_OPTIN
    assert U.ring_shape(4200, NEG).tile == 0
    assert U.ring_shape(4096, NEG).tile == 1
    assert U.ring_shape(1000, NEG).tile == 4


@pytest.mark.parametrize("K", (1, 5, 16))
@pytest.mark.parametrize("d", (1, 48, 50, 500, 1000))
def test_ring_shape_fits_and_aligns(d, K):
    r = U.ring_shape(d, K)
    assert 1 <= r.tile <= P
    assert r.smem_bytes <= U.SMEM_OPTIN and r.stage_bytes % 128 == 0
    assert r.cp_off % 16 == 0 and r.cn_off % 16 == 0
    assert r.cp_off >= 4 * r.tile * d and r.cn_off - r.cp_off >= 4 * r.tile * d
    assert r.stage_bytes >= r.cn_off + 4 * r.tile * K * d
    if r.tile < P:                          # the largest tile that fits
        bigger = U._align(4 * (r.tile + 1) * d, 16)
        stage = U._align(2 * bigger + 4 * (r.tile + 1) * K * d, 128)
        assert U.BAR_BYTES + U.STAGES * stage > U.SMEM_OPTIN


def _stage(plan_entry, d, K, tensors):
    """The stage a tile's copies fill, as float arrays (w, c_pos, c_neg),
    copied span by span as the plan says."""
    _, p0, r, spans = plan_entry
    out = []
    for (first, count, _), t, per in zip(spans, tensors, (d, d, K * d)):
        flat = t.reshape(-1)
        assert first == p0 * per and count == r * per
        out.append(flat[first:first + count].reshape(r, per))
    return out


@pytest.mark.parametrize("N", (1, 7, 4 * P + 3, 10_240))
@pytest.mark.parametrize("d", (48, 50, 500))
def test_tile_plan_covers_every_pair_once_in_order(d, N):
    """Every pair lands in exactly one tile, tiles go to CTA t mod grid in
    ascending order, and a consumer warp j reading row j of each staged
    span sees pair p0 + j's rows. With 16-byte aligned tensors every full
    tile's spans are bulk copies at any d (8 pairs a tile); the tail's go
    by 4-byte copies exactly when their size is not a multiple of 16."""
    ctas = min(-(-N // P), SMS)
    plan = U.tile_plan(N, d, NEG, ctas)
    seen = np.zeros(N, dtype=np.int64)
    last = {}
    rng = np.random.default_rng(N + d)
    tensors = [rng.standard_normal((N, d)), rng.standard_normal((N, d)),
               rng.standard_normal((N, NEG, d))]
    for entry in plan:
        cta, p0, r, spans = entry
        t = p0 // P
        assert p0 % P == 0 and t % ctas == cta
        assert last.get(cta, -1) < t
        last[cta] = t
        seen[p0:p0 + r] += 1
        full = r == P
        for first, count, bulk in spans:
            assert bulk == (count % 4 == 0)          # aligned tensors: the size decides
            if full:
                assert bulk
        if N <= 64:                                  # the staged rows are the pair's
            w, cp, cn = _stage(entry, d, NEG, tensors)
            for j in range(r):
                np.testing.assert_array_equal(w[j], tensors[0][p0 + j])
                np.testing.assert_array_equal(cp[j], tensors[1][p0 + j])
                np.testing.assert_array_equal(cn[j].reshape(NEG, d), tensors[2][p0 + j])
    assert (seen == 1).all()
    tiles = sorted(p0 for _, p0, _, _ in plan)
    assert tiles == list(range(0, N, P))
    if d == 50 and N % P:                            # an odd tail of 200-byte rows
        tail = next(e for e in plan if e[1] == N - N % P)
        assert [s.bulk for s in tail[3]] == [N % 2 == 0] * 3


@pytest.mark.parametrize("N", (7, 10_240))
@pytest.mark.parametrize("d", (48, 500))
def test_misaligned_tensors_take_the_4_byte_path(d, N):
    """A tensor whose data pointer is 4 bytes past a 16-byte boundary (a
    view one float into its storage) has no span that a bulk copy may
    take: every span of it goes by 4-byte copies, the others' by bulk
    copies; and the wrapper picks the scalar column stride, as the first
    design did."""
    ctas = min(-(-N // P), SMS)
    for which in range(3):
        ptrs = [0, 0, 0]
        ptrs[which] = 4
        for _, p0, r, spans in U.tile_plan(N, d, NEG, ctas, ptrs=ptrs):
            for k, s in enumerate(spans):
                if k == which:
                    assert not s.bulk
                elif r == P:
                    assert s.bulk
    storage = torch.zeros(N * d + 1)
    w = storage[1:].view(N, d)
    assert w.data_ptr() % 16 == 4 and w.is_contiguous()
    cp, cn = torch.zeros((N, d)), torch.zeros((N, NEG, d))
    assert U.column_stride(w, cp, cn) == 1
    assert U.column_stride(storage[:-1].view(N, d), cp, cn) == 4
    loss, d_w, d_cp, d_cn = U.sgns_row_grads(w, cp, cn)      # CPU: the plain version
    assert d_w.shape == (N, d) and d_cn.shape == (N, NEG, d)
    assert torch.equal(loss, torch.full((N,), 6 * float(np.log(2.0))))


def test_plain_version_through_the_tile_plan_is_the_whole_batch():
    """The plain version run tile by tile on the staged spans, in each
    CTA's order, assembles the whole batch's outputs: the schedule loses
    and repeats nothing (within 1e-6: torch's CPU sums vectorize by batch
    shape, so a tile's dot products may differ from the batch's by an
    ulp)."""
    N, d = 4 * P + 3, 50
    gen = torch.Generator().manual_seed(0)
    w, cp = (0.3 * torch.randn((N, d), generator=gen) for _ in range(2))
    cn = 0.3 * torch.randn((N, NEG, d), generator=gen)
    want = U.sgns_row_grads_plain(w, cp, cn)
    got = [torch.full_like(t, float("nan")) for t in want]
    for entry in U.tile_plan(N, d, NEG, ctas=2):
        _, p0, r, _ = entry
        ws, cps, cns = _stage(entry, d, NEG, [w.numpy(), cp.numpy(), cn.numpy()])
        out = U.sgns_row_grads_plain(torch.from_numpy(ws), torch.from_numpy(cps),
                                     torch.from_numpy(cns).view(r, NEG, d))
        for g, o in zip(got, out):
            g[p0:p0 + r] = o
    for g, w_ in zip(got, want):
        assert not g.isnan().any()
        torch.testing.assert_close(g, w_, atol=1e-6, rtol=0)
