"""``linear_plan``: how ``decoder_linear``'s wgmma kernel tiles and splits
each product of the decode step (and the ragged shapes of the card tests).
The plan decides the kernel's grid, so its rules are held here on the CPU:
K splits into whole 64-deep slices per CTA, a cluster holds at most 8 CTAs,
every output tile and every K slice is covered exactly once, and a shape
whose output tiles leave room on the SMs is split where K allows it: while
the CTAs stay within 3/4 of the SMs, or within all of them where each CTA
keeps a deep K."""

import pytest

from fpn_mt_image_captioning_torch.ops import fused_decoder as fd

D, DFF, V = 512, 2048, 2000
# (name, K, N) of the decode step's seven linears (flagship widths)
STEP = [("qkv", D, 3 * D), ("out", D, D), ("cross_q", D, D), ("cross_out", D, D),
        ("ffn1", D, DFF), ("ffn2", DFF, D), ("vocab", D, V)]
CASES = ([(f"{name}_m{m}", m, k, n) for m in (64, 512) for name, k, n in STEP]
         + [("ragged_5_24_40", 5, 24, 40), ("ragged_1_8_8", 1, 8, 8),
            ("ragged_64_512_136", 64, 512, 136), ("ragged_100_512_512", 100, 512, 512),
            ("ragged_100_24_40", 100, 24, 40)])


def covered(plan, m, n, k):
    """(output element → times stored, K slice → times read) over the plan's
    grid, as the kernel walks it: CTA ``rank`` of a cluster reads slices
    [rank·kslices, (rank+1)·kslices) and, after the reduction, stores column
    band ``rank`` (bn / split wide) of its tile."""
    tiles, slices = {}, {}
    band = plan.bn // plan.split
    for rank in range(plan.split):
        for gn in range(plan.grid_n):
            for gm in range(plan.grid_m):
                for s in range(rank * plan.kslices, (rank + 1) * plan.kslices):
                    key = (gn, gm, s)
                    slices[key] = slices.get(key, 0) + 1
                c0 = gn * plan.bn + rank * band
                for r in range(gm * plan.bm, min((gm + 1) * plan.bm, m)):
                    for c in range(c0, min(c0 + band, n)):
                        tiles[(r, c)] = tiles.get((r, c), 0) + 1
    return tiles, slices


@pytest.mark.parametrize("name,m,k,n", CASES, ids=[c[0] for c in CASES])
def test_linear_plan(name, m, k, n):
    plan = fd.linear_plan(m, n, k)
    n_slices = -(-k // fd.LINEAR_BK)
    assert plan.bm in (64, 128) and plan.bn == fd.LINEAR_BN
    assert 1 <= plan.split <= fd.MAX_CLUSTER
    assert plan.split * plan.kslices == n_slices          # whole slices, evenly
    tiles, slices = covered(plan, m, n, k)
    assert len(tiles) == m * n and set(tiles.values()) == {1}
    assert len(slices) == plan.grid_n * plan.grid_m * n_slices and set(slices.values()) == {1}
    n_tiles = plan.grid_n * plan.grid_m
    if plan.bm == 128:   # two warpgroups only where 64-row tiles outnumber the SMs
        assert m > 64 and plan.grid_n * -(-m // 64) > fd.H100_SMS
    if n_tiles * 2 <= 3 * fd.H100_SMS // 4 and n_slices % 2 == 0:
        assert plan.split > 1                                 # few tiles: split
    assert n_tiles * plan.split <= max(n_tiles, fd.H100_SMS)  # one CTA an SM at most
    if plan.split < fd.MAX_CLUSTER and n_slices % (2 * plan.split) == 0:
        ctas = n_tiles * 2 * plan.split                        # split as far as allowed
        assert ctas > fd.H100_SMS or (ctas > 3 * fd.H100_SMS // 4
                                      and n_slices // (2 * plan.split) < fd.SPLIT_DEEP)


def test_linear_plan_forced_and_refused():
    assert fd.linear_plan(512, 512, 2048, bm=128, split=8) == fd.LinearPlan(128, 64, 8, 8, 4, 4)
    with pytest.raises(ValueError, match="split"):
        fd.linear_plan(64, 512, 512, split=3)
    with pytest.raises(ValueError, match="split"):
        fd.linear_plan(64, 512, 512, split=16)
    with pytest.raises(ValueError, match="bm"):
        fd.linear_plan(64, 512, 512, bm=96)
