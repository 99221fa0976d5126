"""The PyTorch port's paged-decode kernel on the CPU: its launch plan,
the checks its wrapper makes before any launch, and its plain versions
against the JAX package's Pallas kernels.

csrc/paged_decode.cu's kernel (all four wrappers, the single-query
decode step T = 1 and the speculative verify step T > 1) runs only on
the card. What surrounds it is Python and is held here:

  * verify_plan, the launch the wrapper passes to the kernel: one block
    holds all R = T*G query rows of a kv head (16-row m-tiles, R padded),
    warps split a tile's keys, the grid fills a 132-SM card at
    llama3-8b's, gemma-7b's and gemma-2b's decode (T = 1) and verify
    (T = 4) shapes, the scratch shapes, a block's shared memory under
    227 KB at head_dim 256, and the tiles of every page size (a last box
    of a page's last rows rounded up to 16 where the tiles do not divide
    the page);
  * the split assignment: a mirror of the kernel's walk (Walk::next)
    over the plan's splits visits each visible tile of each visible page
    exactly once, all tiles of a page in one block;
  * _paged_operands / _paged_cuda's refusals on CPU tensors: head dims
    no instantiation builds, dtypes, shapes and contiguity;
  * the plain versions (what the kernel is held against on the card)
    against skypilot_tpu/ops/paged_attention.py's _kernel, _kernel_q,
    _kernel_mq and _kernel_mq_q in interpret mode (as
    tests/test_torch_ops.py and tests/test_torch_gemma.py take them), at
    the kernel's edge cases: R = 2 (T = 2, G = 1), R = 24 (T = 3, G = 8),
    16-token pages, and pages of 8, 24 and 80 tokens at T = 1 and T = 4;
    each with a length-0 slot, T tokens straddling a page boundary, an
    unreserved gap inside a slot's span and a freed slot (all-zero row,
    stale length). Float32, tolerance 2e-5 (atol and rtol), as
    tests/test_torch_ops.py's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops import paged_attention as jax_paged
from skypilot_tpu_torch.ops import paged_attention as pa

ATTN_TOL = dict(atol=2e-5, rtol=2e-5)
SMS = 132      # an H100 SXM's SMs
KIB_227 = 227 * 1024


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers that share
    the host's cores, and these tensors are tiny."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- the plan
# (name, Hq, Hkv, d): the verify step's shapes, 8 slots, T = 4, 64-token
# pages, 32 pages a table row.
SHAPES = {'llama3-8b': (32, 8, 128), 'gemma-7b': (16, 16, 256),
          'gemma-2b': (8, 1, 256)}


def _plan(model, quant, t=4, page=64, mp=32, slots=8):
    hq, hkv, d = SHAPES[model]
    return pa.verify_plan(slots, t, hq, hkv, d, page, mp, quant, SMS)


@pytest.mark.parametrize('quant', [False, True])
def test_plan_llama3_8b(quant):
    """16 rows a kv head: one m-tile, four warps (one 16-key chunk of a
    64-row tile each); 8 splits of 4 pages a (slot, kv head): 512
    blocks; a two-stage ring."""
    plan = _plan('llama3-8b', quant)
    assert (plan.rows, plan.m_tiles, plan.n_mgroups) == (16, 1, 1)
    assert (plan.key_splits, plan.threads, plan.tile_rows) == (4, 128, 64)
    assert plan.n_split == 8 and plan.pages_per_block == 4
    assert plan.grid == (8, 8, 8)
    assert plan.stages == 2
    assert plan.part_acc_shape == (8, 8, 8, 16, 128)
    assert plan.part_ml_shape == (8, 8, 8, 16, 2)


@pytest.mark.parametrize('quant', [False, True])
def test_plan_gemma_7b(quant):
    """4 rows a kv head (G = 1) pad to one 16-row m-tile; 8 splits of 4
    pages (1024 blocks). Over bf16 pages the tiles are 32 rows (two
    warps), so two blocks fit an SM; int8 tiles stay at 64 rows."""
    plan = _plan('gemma-7b', quant)
    assert (plan.rows, plan.m_tiles) == (4, 1)
    assert (plan.tile_rows, plan.key_splits) == ((64, 4) if quant
                                                 else (32, 2))
    assert plan.smem_bytes <= KIB_227 // 2
    assert plan.grid == (8, 16, 8) and plan.pages_per_block == 4
    assert plan.part_acc_shape == (8, 16, 8, 4, 256)
    assert plan.smem_bytes <= KIB_227


@pytest.mark.parametrize('quant', [False, True])
def test_plan_gemma_2b(quant):
    """32 rows on gemma-2b's one kv head: two m-tiles of four warps
    each reading the same tile from shared memory (8 warps); 8 pairs
    take 17 splits of one or two pages each (4 pages a split would leave
    SMs idle): 136 blocks for 132 SMs."""
    plan = _plan('gemma-2b', quant)
    assert (plan.rows, plan.m_tiles, plan.n_mgroups) == (32, 2, 1)
    assert (plan.key_splits, plan.threads) == (4, 256)
    assert plan.grid == (8, 1, 17) and plan.pages_per_block == 2
    assert plan.grid[0] * plan.grid[1] * plan.grid[2] >= SMS
    assert plan.part_ml_shape == (8, 1, 17, 32, 2)


# (model, quant): a decode step's plan (T = 1): rows a kv head, tile rows,
# key splits, grid, mergers.
T1_PLANS = {
    ('llama3-8b', False): (4, 64, 4, (8, 8, 8), 1),
    ('llama3-8b', True): (4, 64, 4, (8, 8, 8), 1),
    ('gemma-7b', False): (1, 32, 2, (8, 16, 8), 1),
    ('gemma-7b', True): (1, 64, 4, (8, 16, 8), 1),
    ('gemma-2b', False): (8, 32, 2, (8, 1, 17), 8),
    ('gemma-2b', True): (8, 64, 4, (8, 1, 17), 8),
}


@pytest.mark.parametrize('model', sorted(SHAPES))
@pytest.mark.parametrize('quant', [False, True])
def test_plan_decode_step(model, quant):
    """T = 1 (a decode step) takes the same kernel: the kv group's G rows
    (4, 1 and 8) pad one 16-row m-tile; llama3-8b's plan is its verify
    step's (512 blocks of four warps), gemma-7b's 1024 blocks take 32-row
    tiles over bf16 pages (two blocks an SM), gemma-2b's one kv head 17
    splits; every grid gives each SM a block, and a block's shared
    memory stays under 227 KB (under half of it at gemma-7b's bf16). The
    merge is shared by 8 blocks a group (one row each) on gemma-2b's grid
    of 136 blocks, and left to one block on llama3-8b's 512 and gemma-7b's
    1024."""
    rows, tile_rows, key_splits, grid, mergers = T1_PLANS[model, quant]
    plan = _plan(model, quant, t=1)
    assert plan.mergers == mergers
    assert (plan.rows, plan.m_tiles, plan.n_mgroups) == (rows, 1, 1)
    assert (plan.tile_rows, plan.tail_rows) == (tile_rows, tile_rows)
    assert plan.key_splits == key_splits
    assert plan.threads == 32 * key_splits
    assert plan.grid == grid and plan.n_split == grid[2]
    assert grid[0] * grid[1] * grid[2] >= SMS
    assert plan.stages == 2
    assert plan.smem_bytes <= KIB_227
    if model == 'gemma-7b' and not quant:
        assert plan.smem_bytes <= KIB_227 // 2
    assert plan.part_acc_shape == (8, grid[1], grid[2], rows,
                                   SHAPES[model][2])
    assert plan.part_ml_shape == (8, grid[1], grid[2], rows, 2)


@pytest.mark.parametrize('slots,t,hq,hkv', [(8, 4, 8, 1), (8, 1, 32, 8),
                                            (8, 4, 16, 16), (1, 1, 8, 1),
                                            (2, 8, 32, 1), (64, 1, 32, 8)])
def test_plan_mergers_leave_an_sm(slots, t, hq, hkv):
    """The blocks that share a group's merge wait for its other blocks;
    all but one per group may wait for a block not yet started. Their
    count over all groups stays below the SMs (so such a block always
    finds one), at most one a row of the smallest row group and one a
    split, and only on a grid of at most two blocks an SM: 16 at
    gemma-2b's verify step, one where the groups alone reach the SM
    count."""
    plan = pa.verify_plan(slots, t, hq, hkv, 128, 64, 32, False, SMS)
    groups = plan.grid[0] * plan.grid[1]
    last_rows = plan.rows - (plan.n_mgroups - 1) * plan.m_tiles * 16
    assert 1 <= plan.mergers <= min(plan.n_split, last_rows)
    assert plan.mergers == 1 or (plan.mergers * groups < SMS and
                                 groups * plan.n_split <= 2 * SMS)
    assert plan.mergers == {(8, 4, 8, 1): 16, (64, 1, 32, 8): 1}.get(
        (slots, t, hq, hkv), plan.mergers)


@pytest.mark.parametrize('model', sorted(SHAPES))
@pytest.mark.parametrize('quant', [False, True])
def test_plan_fills_the_card(model, quant):
    """At every verify shape the grid gives each SM at least one block,
    and no block holds more than 8 warps or 8 m-tiles."""
    plan = _plan(model, quant)
    assert plan.grid[0] * plan.grid[1] * plan.grid[2] >= SMS
    assert plan.threads <= 32 * pa.VERIFY_MAX_WARPS
    assert plan.m_tiles <= pa.VERIFY_MAX_M_TILES
    assert plan.n_split <= 32


@pytest.mark.parametrize('page', [16, 32, 48, 64, 128, 256])
@pytest.mark.parametrize('rows', [(4, 4, 1), (4, 8, 1), (6, 8, 1),
                                  (8, 16, 1), (8, 32, 1)])
@pytest.mark.parametrize('quant', [False, True])
def test_plan_d256_shared_memory(page, rows, quant):
    """Head_dim 256 at R = 16, 32, 48, 128, 256 and every page size the
    kernel takes: a block's shared memory stays under 227 KB, the ring
    keeps at least two stages and a tile of at most 64 page rows that
    divides the page (32 rows for one bf16 m-tile)."""
    t, hq, hkv = rows
    plan = pa.verify_plan(8, t, hq, hkv, 256, page, 8, quant, SMS)
    assert plan.smem_bytes <= KIB_227
    assert plan.stages >= 2
    assert plan.tile_rows <= 64 and plan.tile_rows % 16 == 0
    assert page % plan.tile_rows == 0
    one_bf16_tile = not quant and plan.m_tiles == 1 and page % 32 == 0
    assert plan.tile_rows == (32 if one_bf16_tile else min(page, 64))
    assert plan.smem_bytes == pa.verify_smem_bytes(
        256, quant, plan.tile_rows, plan.stages, plan.m_tiles,
        plan.threads // 32)


def test_plan_row_groups_past_eight_m_tiles():
    """R = 256 (T = 8 on 32 q heads a kv head): 16 m-tiles in two groups
    of 8; R = 144 (9 m-tiles) in two groups of 5, none of them empty."""
    plan = pa.verify_plan(2, 8, 32, 1, 64, 64, 4, False, SMS)
    assert (plan.rows, plan.m_tiles, plan.n_mgroups) == (256, 8, 2)
    assert plan.key_splits == 1 and plan.grid[1] == 2
    plan = pa.verify_plan(2, 9, 16, 1, 64, 64, 4, False, SMS)
    assert (plan.rows, plan.m_tiles, plan.n_mgroups) == (144, 5, 2)
    assert (plan.n_mgroups - 1) * plan.m_tiles * 16 < plan.rows


def test_plan_short_tables_cap_the_splits():
    """A split is at least one page: 2 pages a row give 2 splits."""
    plan = pa.verify_plan(1, 4, 32, 8, 128, 64, 2, False, SMS)
    assert plan.n_split == 2 and plan.pages_per_block == 1


def test_plan_long_tables_take_four_pages_a_block():
    """A long table row on a grid that fills the card: about
    VERIFY_PAGES_PER_BLOCK pages a block (512 pages: 128 splits)."""
    plan = pa.verify_plan(8, 4, 32, 8, 128, 64, 512, False, SMS)
    assert plan.n_split == 128 and plan.pages_per_block == 4


# (page size, tile rows, box rows of a page's last tile) at llama3-8b's
# verify shape: pages up to 64 rows are one tile of their rows rounded up
# to 16; longer ones 64-row tiles and a smaller last box.
PAGE_TILES = {8: (16, 16), 24: (32, 32), 40: (48, 48), 80: (64, 16),
              96: (64, 32), 200: (64, 16)}


@pytest.mark.parametrize('page', [8, 24, 40, 80, 96, 200])
def test_plan_takes_page_sizes(page):
    """Page sizes the TMA tiles do not divide are taken: a box of at
    most 64 rows, a multiple of 16, and a last box that covers the
    page's last rows."""
    plan = pa.verify_plan(8, 4, 32, 8, 128, page, 8, False, SMS)
    assert (plan.tile_rows, plan.tail_rows) == PAGE_TILES[page]
    tiles = -(-page // plan.tile_rows)
    assert (tiles - 1) * plan.tile_rows + plan.tail_rows >= page
    assert plan.tail_rows - 16 < page - (tiles - 1) * plan.tile_rows
    assert plan.key_splits == plan.tile_rows // 16
    assert plan.smem_bytes <= KIB_227


def _walk(plan, page, length, t, row):
    """The kernel's walk (csrc/paged_decode.cu Walk::next) for one slot
    of one (kv head, row group): {split: [(page j, tile st), ...]}."""
    last = length + t - 1
    n_visit = 0 if length < 0 else min(len(row), last // page + 1)
    tr = plan.tile_rows
    walked = {}
    for split in range(plan.n_split):
        j, st, tiles = split, -1, []
        while True:
            st += 1
            while j < n_visit and not (
                    (j == 0 or row[j] != 0) and st * tr < page and
                    j * page + st * tr <= last):
                j, st = j + plan.n_split, 0
            if j >= n_visit:
                break
            tiles.append((j, st))
        walked[split] = tiles
    return walked


@pytest.mark.parametrize('page', [8, 16, 24, 40, 64, 80, 96, 128, 200])
@pytest.mark.parametrize('t', [1, 4])
def test_walk_visits_each_visible_tile_once(page, t):
    """Over the plan's splits, lengths 0, P-1, P and a long slot (with
    an unreserved gap at page 1) and a freed slot: each visible page's
    tiles that start at a position some token sees are walked exactly
    once, all by one block; their boxes (tile_rows, or tail_rows for a
    page's short last tile) cover every visible position; no block walks
    anything else."""
    mp = 12
    plan = pa.verify_plan(4, t, 32, 8, 128, page, mp, False, SMS)
    tr = plan.tile_rows
    for length, row in ((0, [5] + [0] * (mp - 1)),
                        (page - 1, [5, 6] + [0] * (mp - 2)),
                        (page, [5, 6] + [0] * (mp - 2)),
                        (9 * page + 3, [5, 0] + list(range(7, 7 + mp - 2))),
                        (999, [0] * mp)):
        last = length + t - 1
        walked = _walk(plan, page, length, t, row)
        seen = [(j, st) for tiles in walked.values() for j, st in tiles]
        assert len(seen) == len(set(seen))
        want = {(j, st) for j in range(min(mp, last // page + 1))
                if j == 0 or row[j] != 0
                for st in range(-(-page // tr))
                if j * page + st * tr <= last}
        assert set(seen) == want
        for split, tiles in walked.items():
            assert all(j % plan.n_split == split for j, _ in tiles)
        covered = set()
        for j, st in seen:
            valid = min(tr, page - st * tr)
            box = plan.tail_rows if valid < tr else tr
            assert valid <= box <= tr and box % 16 == 0
            covered |= {j * page + st * tr + k for k in range(valid)}
        visible = {p for p in range(min(mp * page, last + 1))
                   if p // page == 0 or row[p // page] != 0}
        assert visible <= covered


# ------------------------------------------------------ the wrapper's checks
def _operands(t=4, hq=8, hkv=2, d=128, page=64, n_pages=5, mp=4,
              quant=False, slots=3):
    q = torch.zeros((slots, t, hq, d), dtype=torch.bfloat16)
    kv = torch.int8 if quant else torch.bfloat16
    kp = torch.zeros((n_pages, hkv, page, d), dtype=kv)
    vp = torch.zeros((n_pages, hkv, page, d), dtype=kv)
    ks = vs = None
    if quant:
        ks = torch.ones((n_pages, hkv, page))
        vs = torch.ones((n_pages, hkv, page))
    tables = torch.zeros((slots, mp), dtype=torch.int32)
    lengths = torch.zeros((slots,), dtype=torch.int32)
    return [q, kp, vp, ks, vs, tables, lengths]


@pytest.mark.parametrize('quant', [False, True])
def test_operands_give_the_plan(quant):
    """A valid call gives verify_plan's plan for its shapes: a verify
    call, and a T = 1 call (the same kernel) at any page size."""
    ops = _operands(quant=quant)
    plan = pa._paged_operands('paged_decode_mq', *ops)
    assert plan == pa.verify_plan(3, 4, 8, 2, 128, 64, 4, quant, SMS)
    ops = _operands(t=1, page=24, quant=quant)
    plan = pa._paged_operands('paged_decode', *ops)
    assert plan == pa.verify_plan(3, 1, 8, 2, 128, 24, 4, quant, SMS)
    assert (plan.rows, plan.tile_rows, plan.tail_rows) == (4, 32, 32)


@pytest.mark.parametrize('d', [32, 192, 320])
def test_wrapper_refuses_unbuilt_head_dims(d):
    ops = _operands(d=d)
    with pytest.raises(ValueError, match='ROADMAP.md'):
        pa._paged_cuda('paged_decode_mq', *ops)


@pytest.mark.parametrize('page', [8, 24, 80])
@pytest.mark.parametrize('quant', [False, True])
def test_wrapper_takes_page_sizes(page, quant):
    """The wrapper's checks pass pages the tiles do not divide (a spec
    engine's verify call at page 8, 24 or 80), with the plan's tiles."""
    ops = _operands(page=page, quant=quant)
    plan = pa._paged_operands('paged_decode_mq', *ops)
    assert (plan.tile_rows, plan.tail_rows) == PAGE_TILES[page]


def test_wrapper_refuses_dtypes():
    ops = _operands()
    ops[0] = ops[0].float()
    with pytest.raises(TypeError, match='q'):
        pa._paged_cuda('paged_decode_mq', *ops)
    ops = _operands()           # bf16 pools with scales: int8 expected
    ops[3] = ops[4] = torch.ones((5, 2, 64))
    with pytest.raises(TypeError, match='k_pool'):
        pa._paged_cuda('paged_decode_mq_q', *ops)
    ops = _operands(quant=True)
    ops[3] = ops[3].double()
    with pytest.raises(ValueError, match='k_scale'):
        pa._paged_cuda('paged_decode_mq_q', *ops)
    ops = _operands()
    ops[5] = ops[5].long()
    with pytest.raises(ValueError, match='tables'):
        pa._paged_cuda('paged_decode_mq', *ops)


def test_wrapper_refuses_layouts():
    ops = _operands()
    ops[0] = ops[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match='q must be contiguous'):
        pa._paged_cuda('paged_decode_mq', *ops)
    ops = _operands()
    ops[2] = torch.zeros((5, 2, 64, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='shape mismatch'):
        pa._paged_cuda('paged_decode_mq', *ops)
    ops = _operands(quant=True)
    ops[4] = torch.ones((5, 2, 32))
    with pytest.raises(ValueError, match='v_scale'):
        pa._paged_cuda('paged_decode_mq_q', *ops)
    ops = _operands()
    ops[6] = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match='lengths'):
        pa._paged_cuda('paged_decode_mq', *ops)
    ops = _operands(hq=6, hkv=4)
    with pytest.raises(ValueError, match='Hq % Hkv'):
        pa._paged_cuda('paged_decode_mq', *ops)


# ------------------------------------------- plain versions vs Pallas
def _case(seed, t, hq, hkv, d, page, quant):
    """5 slots: length 0, one page less one (its T tokens straddle the
    page boundary), 3 pages + 5 with an unreserved gap at page 1, a
    freed slot (all-zero row, stale length 999), 2 pages + 3."""
    rng = np.random.default_rng(seed)
    lengths = [0, page - 1, 3 * page + 5, 999, 2 * page + 3]
    need = [0 if s == 3 else -(-(n + t) // page)
            for s, n in enumerate(lengths)]
    mp, n_pages = max(need) + 1, sum(need) + 1
    perm = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((len(lengths), mp), np.int32)
    nxt = 0
    for s, n in enumerate(need):
        tables[s, :n] = perm[nxt:nxt + n]
        nxt += n
    tables[2, 1] = 0
    q = rng.normal(size=(len(lengths), t, hq, d)).astype(np.float32)
    shape = (n_pages, hkv, page, d)
    if quant:
        pools = [rng.integers(-127, 128, shape).astype(np.int8)
                 for _ in range(2)]
        pools += [(rng.random(shape[:3]) * 0.05).astype(np.float32)
                  for _ in range(2)]
    else:
        pools = [rng.normal(size=shape).astype(np.float32)
                 for _ in range(2)]
    return [q] + pools + [tables, np.asarray(lengths, np.int32)]


# (name, T, Hq, Hkv, d, page): R = 2, R = 24, 16-token pages (R = 8);
# pages of 8, 24 and 80 tokens (one 16-row box with 8 rows past the page,
# one 32-row box with 8, a 64-row tile and a 16-row last box) at T = 1
# (the single-query kernels) and T = 4.
EDGE_CASES = [
    ('r2', 2, 4, 4, 64, 64),
    ('r24', 3, 16, 2, 64, 64),
    ('p16', 4, 4, 2, 64, 16),
    ('p8_t1', 1, 8, 2, 64, 8),
    ('p24_t1', 1, 4, 4, 64, 24),
    ('p80_t1', 1, 8, 2, 64, 80),
    ('p8', 4, 4, 2, 64, 8),
    ('p24', 4, 8, 2, 64, 24),
    ('p80', 4, 4, 4, 64, 80),
]


@pytest.mark.parametrize('quant', [False, True])
@pytest.mark.parametrize('name,t,hq,hkv,d,page', EDGE_CASES)
def test_plain_verify_matches_pallas_interpret(name, t, hq, hkv, d, page,
                                               quant):
    fn = 'paged_decode_attention' + ('_mq' if t > 1 else '') + \
        ('_q' if quant else '')
    args = _case(len(name) * 7 + t, t, hq, hkv, d, page, quant)
    if t == 1:
        args[0] = args[0][:, 0]
    ref = getattr(jax_paged, fn)(*(jnp.asarray(a) for a in args))
    out = getattr(pa, fn)(*(torch.from_numpy(a) for a in args))
    assert out.shape == args[0].shape
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ATTN_TOL)
