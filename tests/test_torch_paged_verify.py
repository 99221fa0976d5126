"""The PyTorch port's speculative-verify paged-decode kernel on the CPU:
its launch plan, the checks its wrapper makes before any launch, and its
plain versions against the JAX package's Pallas kernels.

csrc/paged_decode.cu's verify kernel (paged_decode_attention_mq and
paged_decode_attention_mq_q for T > 1) runs only on the card. What
surrounds it is Python and is held here:

  * verify_plan, the launch the wrapper passes to the kernel: one block
    holds all R = T*G query rows of a kv head (16-row m-tiles, R padded),
    warps split a tile's keys, the grid fills a 132-SM card at
    llama3-8b's, gemma-7b's and gemma-2b's verify shapes, the scratch
    shapes, and a block's shared memory under 227 KB at head_dim 256;
  * _paged_operands / _paged_cuda's refusals on CPU tensors: head dims
    no instantiation builds, page sizes the kernel's TMA tiles do not
    take, dtypes, shapes and contiguity;
  * the plain versions (what the kernel is held against on the card)
    against skypilot_tpu/ops/paged_attention.py's _kernel_mq and
    _kernel_mq_q in interpret mode (as tests/test_torch_ops.py and
    tests/test_torch_gemma.py take them), at the kernel's edge cases:
    R = 2 (T = 2, G = 1), R = 24 (T = 3, G = 8), 16-token pages; each
    with a length-0 slot, T tokens straddling a page boundary, an
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


@pytest.mark.parametrize('page', [8, 24, 40, 80, 96, 200])
def test_plan_refuses_page_sizes(page):
    with pytest.raises(ValueError, match='page sizes'):
        pa.verify_plan(8, 4, 32, 8, 128, page, 8, False, SMS)


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
    """A valid verify call: the plan is verify_plan's for its shapes; a
    T = 1 call has none (the single-query kernel), whatever its page
    size."""
    ops = _operands(quant=quant)
    plan = pa._paged_operands('paged_decode_mq', *ops)
    assert plan == pa.verify_plan(3, 4, 8, 2, 128, 64, 4, quant, SMS)
    ops = _operands(t=1, page=24, quant=quant)
    assert pa._paged_operands('paged_decode', *ops) is None


@pytest.mark.parametrize('d', [32, 192, 320])
def test_wrapper_refuses_unbuilt_head_dims(d):
    ops = _operands(d=d)
    with pytest.raises(ValueError, match='ROADMAP.md'):
        pa._paged_cuda('paged_decode_mq', *ops)


@pytest.mark.parametrize('page', [8, 24, 80])
@pytest.mark.parametrize('quant', [False, True])
def test_wrapper_refuses_page_sizes(page, quant):
    ops = _operands(page=page, quant=quant)
    with pytest.raises(ValueError, match='page sizes'):
        pa._paged_cuda('paged_decode_mq', *ops)


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


# (name, T, Hq, Hkv, d, page): R = 2, R = 24, 16-token pages (R = 8).
EDGE_CASES = [
    ('r2', 2, 4, 4, 64, 64),
    ('r24', 3, 16, 2, 64, 64),
    ('p16', 4, 4, 2, 64, 16),
]


@pytest.mark.parametrize('quant', [False, True])
@pytest.mark.parametrize('name,t,hq,hkv,d,page', EDGE_CASES)
def test_plain_verify_matches_pallas_interpret(name, t, hq, hkv, d, page,
                                               quant):
    fn = 'paged_decode_attention_mq_q' if quant else \
        'paged_decode_attention_mq'
    args = _case(len(name) * 7 + t, t, hq, hkv, d, page, quant)
    ref = getattr(jax_paged, fn)(*(jnp.asarray(a) for a in args))
    out = getattr(pa, fn)(*(torch.from_numpy(a) for a in args))
    assert out.shape == args[0].shape
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ATTN_TOL)
