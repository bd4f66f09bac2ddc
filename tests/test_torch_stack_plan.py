"""The layout of the port's wavefront stack kernels (`cuda_stack.stack_plan`),
on the CPU.

The stack kernels spread every layer of a stack over the card at once: batch
groups, and in each a set of CTAs per layer that hold the layer's factor
slices in shared memory for the whole launch. Here the shapes that
`chip_smoke.py`, the CUDA tests and the LM give the kernels, and ragged
ones, are checked for a layout that covers every row, gate column, rank
column and x rank column exactly once, fits the card, and gives each layer
CTAs in proportion to its work; and `stack_fits`, which groups a stack, is
checked to be the plan's criterion.
"""

import pytest

torch = pytest.importorskip("torch")

from vmlmf_tpu_torch.ops import cuda_stack  # noqa: E402

SMS = 132  # an H100 SXM
LM = (650, (300, 300), (300,))  # the PTB LM stack: h, ranks, x ranks

# (B, h, ranks, x ranks): the LM stack at the batches its paths run, the
# CUDA tests' stacks, and ragged ones: h and r not dividing the CTAs, r and
# rx below the CTA count, unequal ranks, three to eight layers
SHAPES = [
    *((b, *LM) for b in (1, 20, 128)),
    (5, 33, (6, 9, 4), (5, 7)), (3, 16, (4, 4), (4,)), (6, 20, (3, 5), (4,)),
    (1, 650, (37, 300), (13,)), (20, 650, (37, 300), (13,)), (1, 650, (300, 40), (300,)),
    (7, 250, (20, 70), (9,)), (257, 64, (9, 9), (9,)), (20, 181, (1, 1, 1), (1, 1)),
    (4, 16, (2,) * 8, (2,) * 7), (1, 7, (1, 1), (1,)), (20, 1000, (100, 100), (100,)),
]


def check_plan(b, h, ranks, xranks, sms=SMS, elsize=4):
    """Every row in one group; in each layer, every gate column, rank column
    and x rank column on exactly one of its CTAs; shared memory within a
    block's 227 KB; the grid within the SMs at one CTA each."""
    plan = cuda_stack.stack_plan(b, h, ranks, xranks, sms, elsize)
    assert plan.elsize == elsize and plan.ranks == tuple(ranks) and plan.xranks == tuple(xranks)
    assert plan.n_ctas <= sms
    assert plan.smem_bytes <= cuda_stack.SMEM_LIMIT == 227 * 1024
    assert plan.rpad % 4 == 0 and plan.rpad >= -(-b // plan.groups)
    assert plan.stage_fwd % plan.rpad == 0 and plan.stage_bwd % plan.rpad == 0
    rows = [0] * b
    for g in range(plan.groups):
        b0, b1 = plan.rows(g)
        assert 0 < b1 - b0 <= plan.rpad
        for i in range(b0, b1):
            rows[i] += 1
    assert rows == [1] * b
    assert len(plan.ctas) == len(ranks)
    for l, c in enumerate(plan.ctas):
        assert 1 <= c <= h
        gate_cols, rank_cols, x_cols = [0] * (4 * h), [0] * ranks[l], [0] * plan.rx(l)
        for q in range(c):
            j0, j1 = plan.j_range(l, q)
            assert j1 > j0
            for g in range(4):
                for j in range(j0, j1):
                    gate_cols[g * h + j] += 1
            for cols, (k0, k1) in ((rank_cols, plan.k_range(l, q)), (x_cols, plan.kx_range(l, q))):
                for k in range(k0, k1):
                    cols[k] += 1
        assert gate_cols == [1] * (4 * h) and rank_cols == [1] * ranks[l]
        assert x_cols == [1] * plan.rx(l)
    return plan


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_covers_every_column_once_and_fits_the_card(shape):
    check_plan(*shape)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bf16_plan_covers_every_column_once_and_fits_the_card(shape):
    plan, f32 = check_plan(*shape, elsize=2), cuda_stack.stack_plan(*shape)
    # half the bytes a weight slice: at least as many copies of the factors
    assert plan.groups >= f32.groups


def test_lm_stack_splits_the_sms_by_step_work():
    """Layer 0 does h*r + r*4h multiply-adds a row and step (975,000 at LM
    width), layer 1 twice that with its x side: 44 and 88 of 132 SMs, one
    group, each CTA holding about 90 KB of f32 factors."""
    for b in (1, 20, 128):
        plan = check_plan(b, *LM)
        assert (plan.groups, plan.ctas) == (1, (44, 88))
    assert cuda_stack._layer_work(*LM) == [975000, 1950000]


@pytest.mark.parametrize("shape", [s for s in SHAPES if sum(cuda_stack.stack_plan(*s).ctas) > 3],
                         ids=str)
def test_ctas_follow_each_layer_s_step_work(shape):
    """A layer's share of a group's CTAs is its share of the multiply-adds
    of a step, within one CTA (or pinned at one CTA, or at h)."""
    b, h, ranks, xranks = shape
    plan = check_plan(*shape)
    work = cuda_stack._layer_work(h, ranks, xranks)
    total = sum(plan.ctas)
    for c, w in zip(plan.ctas, work):
        assert c in (1, h) or abs(c - total * w / sum(work)) <= 1


def test_split_ctas_hands_out_the_remainder_by_largest_fraction():
    assert cuda_stack._split_ctas(132, [1, 2], 650) == (44, 88)
    assert cuda_stack._split_ctas(10, [1, 1, 1], 650) == (4, 3, 3)
    assert cuda_stack._split_ctas(5, [100, 1, 1], 650) == (3, 1, 1)
    assert cuda_stack._split_ctas(9, [1, 1], 4) == (4, 4)  # at most h each
    for total in range(3, 140):
        got = cuda_stack._split_ctas(total, [975000, 1950000, 1950000], 650)
        assert sum(got) == total and min(got) >= 1


def test_plan_takes_ragged_slices():
    """h and r that do not divide the CTAs, and ranks below the CTA count:
    some CTAs own no rank column, every CTA owns hidden units."""
    plan = check_plan(1, 650, (37, 300), (13,))
    assert plan.groups == 1 and 650 % plan.ctas[0] and 650 % plan.ctas[1]
    plan = cuda_stack.stack_layout(4, 650, (30, 300), (7,), 1, (40, 92))
    assert plan.n_ctas == 132 and plan.smem_bytes <= cuda_stack.SMEM_LIMIT
    empty = [q for q in range(40) if plan.k_range(0, q)[0] == plan.k_range(0, q)[1]]
    assert len(empty) == 40 - 30                      # r = 30 over 40 CTAs of layer 0
    for q in range(40):
        j0, j1 = plan.j_range(0, q)
        assert j1 - j0 in (16, 17)                    # 650 over 40: ragged


def test_a_layer_with_an_x_side_gives_each_cta_one_kind_of_rank_column():
    """A layer l >= 1 on several CTAs: its first CTAs (in proportion r : rx)
    own U's rank columns, the others Ux's, none both, so that each runs one
    product in phase A; a layer on one CTA owns both."""
    plan = check_plan(20, *LM)
    ua = cuda_stack._rank_split(88, 300, 300)[0]
    assert ua == 44
    for q in range(88):
        k, kx = plan.k_range(1, q), plan.kx_range(1, q)
        assert (k[1] > k[0]) == (q < ua) and (kx[1] > kx[0]) == (q >= ua)
    tiny = check_plan(3, 16, (4, 4), (4,))
    assert tiny.ctas == (1, 1) and tiny.k_range(1, 0) == (0, 4) and tiny.kx_range(1, 0) == (0, 4)
    assert cuda_stack._rank_split(10, 300, 1) == (9, 36, 4, False)  # clamped: one Ux CTA


def test_plan_groups_the_batch_where_the_factors_fit_many_times():
    tiny = check_plan(3, 16, (4, 4), (4,))         # a few KB: a group per row
    assert tiny.groups == 3 and tiny.ctas == (1, 1)
    assert check_plan(20, *LM, elsize=2).groups > 1  # bf16 slices: copies of the factors


def test_plan_layout_matches_its_parts():
    """smem is the largest layer's carve plus the staging and the partials,
    as the sources' fwd_smem_floats and bwd_smem_floats count it."""
    plan = check_plan(20, *LM)
    for k, smem, stage, red in ((0, plan.smem_fwd, plan.stage_fwd, plan.red_fwd),
                                (1, plan.smem_bwd, plan.stage_bwd, plan.red_bwd)):
        carve = max(cuda_stack._layer_layout(650, r, rx, c, plan.rpad, 4)[k][0]
                    for r, rx, c in zip(plan.ranks, (0, *plan.xranks), plan.ctas))
        assert smem == 4 * (carve + stage + red)
    assert plan.layer_ints() == [300, 0, 44, 300, 300, 88]
    assert plan.ints("fwd")[:2] == plan.ints("bwd")[:2] == (1, 20)


def test_f32_and_bf16_give_the_same_stack_fits():
    """`stack_fits` asks for an f32 plan whatever the precision, as the JAX
    package's does; a bf16 plan exists wherever an f32 one does."""
    for b, h, ranks, xranks in SHAPES:
        assert cuda_stack.stack_plan(b, h, ranks, xranks, elsize=2)
    for n in (2, 3, 4):
        one = {"u": torch.empty(650, 300), "v": torch.empty(300, 2600)}
        layers = [one] + [dict(one, ux=one["u"], vx=one["v"])] * (n - 1)
        fits = cuda_stack.stack_fits(layers)
        ranks, xranks = cuda_stack._stack_ranks(layers)
        assert fits == (n <= 3)
        if fits:
            cuda_stack.stack_plan(1, 650, ranks, xranks, elsize=2)


@pytest.mark.parametrize("b", [1, 20, 128, 160, 300, 1024, 4096])
def test_stack_chunks_cut_a_large_batch_into_rows_each_with_a_plan(b):
    """A batch whose staging does not fit one plan (the f32 LM stack above
    B=164) runs in chunks of consecutive rows, one launch each: as few as
    have a plan each, their sizes at most one apart, covering every row
    once."""
    for elsize in (4, 2):
        chunks = cuda_stack.stack_chunks(b, *LM, elsize=elsize)
        assert chunks[0][0] == 0 and sum(n for _, n, _ in chunks) == b
        assert all(b0 + n == b1 for (b0, n, _), (b1, _, _) in zip(chunks, chunks[1:]))
        assert max(n for _, n, _ in chunks) - min(n for _, n, _ in chunks) <= 1
        for _, n, plan in chunks:
            assert plan == check_plan(n, *LM, elsize=elsize)
        if b <= 160:
            assert len(chunks) == 1
    assert len(cuda_stack.stack_chunks(b, *LM)) == {300: 2, 1024: 6, 4096: 24}.get(b, 1)


def test_plan_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="do not fit"):
        cuda_stack.stack_plan(128, 650, (300,) * 3, (300,) * 2)  # 19.5 MB of f32 factors
    with pytest.raises(ValueError, match="stack_groups"):
        cuda_stack.stack_plan(1, 2000, (1000, 1000), (1000,))
    with pytest.raises(ValueError, match="stack_groups"):      # not even in chunks
        cuda_stack.stack_chunks(20, 2000, (1000, 1000), (1000,))
    with pytest.raises(ValueError, match="do not fit"):
        cuda_stack.stack_plan(20, *LM, sms=40)                   # too few SMs
    with pytest.raises(ValueError, match="no stack plan"):
        cuda_stack.stack_plan(20, 650, (300, 300), ())           # an x rank missing
    with pytest.raises(ValueError, match="no stack plan"):
        cuda_stack.stack_plan(20, 16, (2,) * 9, (2,) * 8)        # past the kernels' depth
