"""Launch geometry of the flash kernels, and the rule that picks their
family, on the CPU.

``horovod_tpu_torch.ops._cuda.flash_plan`` is the host-side plan of the
warp-specialised Hopper kernels ``csrc/flash_fwd.cu`` (P1),
``csrc/flash_bwd_dkdv.cu`` (P2), ``csrc/flash_bwd_dq.cu`` (P3) and
``csrc/flash_bwd_fused.cu`` (P6), whose C entry points check it: padded
head size, tile rows, grid, ring stages, dynamic shared memory and the
TMA boxes; ``tma_strides`` gives the tensor maps' byte strides.
``general_plan`` is the plan of the general family G1-G3
(``csrc/flash_general.cu``), and ``flash_family`` decides which family
takes an input.  The kernels themselves run only on the card
(``chip_smoke.py``); here every head size the wrappers accept meets the
card's limits at every length.
"""

import importlib.util
import re
from pathlib import Path

import pytest
import torch

from horovod_tpu_torch.ops import _cuda

ROOT = Path(__file__).resolve().parents[1]

KERNELS = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq", "flash_bwd_fused")
GENERAL = ("flash_fwd_general", "flash_bwd_dkdv_general",
           "flash_bwd_dq_general")
HEAD_SIZES = tuple(range(16, 129, 16))
LENGTHS = (1, 63, 64, 127, 128, 200, 2048, 16384)
SWIZZLE_BYTES = 128   # CU_TENSOR_MAP_SWIZZLE_128B: a box row is 128 bytes


def _tile_of_block(kernel, x, tiles):
    """The tile that block x works on, as the kernels map it: P1 and P3
    issue the last (heaviest causal) q tile first, P2 and P6 the first kv
    tile."""
    return tiles - 1 - x if kernel in ("flash_fwd", "flash_bwd_dq") else x


@pytest.mark.parametrize("T", LENGTHS)
@pytest.mark.parametrize("D", HEAD_SIZES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_plan_fits_the_card_and_covers_every_tile(kernel, D, T):
    B, H = 2, 3
    plan = _cuda.flash_plan(kernel, B, H, T, D)
    assert plan.smem_bytes <= _cuda.SMEM_LIMIT == 232_448
    assert plan.d_pad in (64, 128) and plan.d_pad >= D
    assert plan.stages >= 2
    tiles, heads, batches = plan.grid
    assert (heads, batches) == (H, B)
    # Every tile of the block side exactly once, and no tile past T.
    got = sorted(_tile_of_block(kernel, x, tiles) for x in range(tiles))
    assert got == list(range(tiles))
    covered = {r for i in got for r in range(i * plan.rows,
                                              min((i + 1) * plan.rows, T))}
    assert covered == set(range(T))
    assert (tiles - 1) * plan.rows < T
    # Boxes: one swizzle span of columns, one head, one batch, the tile's
    # rows; d_pad / 64 of them cover the padded head, each 1024-byte
    # aligned in shared memory.
    for box in plan.boxes.values():
        cols, hs, rows, bs = box
        assert cols * 2 == SWIZZLE_BYTES and hs == bs == 1
        assert rows in (plan.rows, plan.stream_rows) and rows <= 256
        assert plan.d_pad % cols == 0 and rows * SWIZZLE_BYTES % 1024 == 0


@pytest.mark.parametrize("kernel,want", [
    # D 128: 1024 slack + q 32 KiB + 2 stages x (k, v) 64 KiB + 7 barriers.
    ("flash_fwd", 1024 + 32768 + 2 * 2 * 32768 + 8 * 7),
    # D 128: 1024 slack + k, v 64 KiB + 2 stages x (q, dO 32 KiB + lse,
    # delta 512 B) + 5 barriers.
    ("flash_bwd_dkdv", 1024 + 2 * 32768 + 2 * (2 * 16384 + 512) + 8 * 5),
    # D 128: 1024 slack + q, dO 64 KiB + 2 stages x (k, v) 32 KiB + 5
    # barriers.
    ("flash_bwd_dq", 1024 + 2 * 32768 + 2 * 2 * 16384 + 8 * 5),
    # P2's, plus two 128 x 64 bf16 ds^T tiles and four 64 x 64 f32 dq
    # tiles.
    ("flash_bwd_fused", 1024 + 2 * 32768 + 2 * (2 * 16384 + 512)
     + 2 * 16384 + 4 * 16384 + 8 * 5),
])
def test_plan_at_the_training_shape(kernel, want):
    plan = _cuda.flash_plan(kernel, 8, 16, 2048, 128)
    assert plan.smem_bytes == want
    assert plan.grid == (16, 16, 8)
    assert plan.d_pad == 128
    assert (plan.rows, plan.stream_rows) == (
        (128, 128) if kernel == "flash_fwd" else (128, 64))


def test_plan_refuses_other_kernels():
    for name in ("flash_bwd", "flash_fwd_general", "int8_quantize"):
        with pytest.raises(ValueError, match="no launch plan"):
            _cuda.flash_plan(name, 1, 1, 64, 64)
    with pytest.raises(ValueError, match="no general launch plan"):
        _cuda.general_plan("flash_fwd", 1, 1, 64, 64)


GEN_DTYPES = (torch.float32, torch.float16, torch.bfloat16)


def _general_cells(kernel, plan, T, D):
    """The (row, column) cells each block of a general kernel writes, as
    the kernels map blocks: G1 the 64 q rows ``(blocks - 1 - x) * 64 ..``
    (heaviest first), G2 the 64 key rows ``(x // halves) * 64 ..`` and one
    column half, G3 the same q rows as G1."""
    blocks, _, _ = plan.grid
    for x in range(blocks):
        if kernel == "flash_bwd_dkdv_general":
            kb, half = divmod(x, plan.halves)
            r0 = kb * plan.rows
            c0 = half * plan.half_cols
            c1 = plan.d8 if half else plan.half_cols
        else:
            r0 = (blocks - 1 - x) * plan.rows
            c0, c1 = 0, plan.d8
        yield x, [(r, c) for r in range(r0, min(r0 + plan.rows, T))
                  for c in range(c0, c1)]


@pytest.mark.parametrize("kernel", GENERAL)
def test_general_plan_fits_the_card_and_covers_every_row(kernel):
    """G1-G3: one block of 128 threads per 64 rows of a head (and per
    column half of dk/dv for G2 beyond D8 = 128), columns padded to D8, a
    multiple of 8 below D + 8, in every dtype.  Every row (and column) is
    covered exactly once at every head size up to 256 and every length,
    and shared memory fits."""
    B, H = 2, 3
    for dtype in GEN_DTYPES:
        for D in range(1, _cuda.GENERAL_MAX_D + 1):
            for T in (1, 15, 16, 17, 200, 2048):
                plan = _cuda.general_plan(kernel, B, H, T, D, dtype)
                blocks, heads, batches = plan.grid
                assert (heads, batches, plan.threads) == (H, B, 128)
                assert plan.smem_bytes <= _cuda.SMEM_LIMIT
                assert plan.rows == 64
                assert plan.d8 % 8 == 0 and D <= plan.d8 < D + 8
                dkdv = kernel == "flash_bwd_dkdv_general"
                assert plan.halves == (2 if dkdv and plan.d8 > 128 else 1)
                if dkdv:   # dk and dv of a half fit in registers
                    assert plan.half_cols % 8 == 0
                    assert plan.d8 - plan.half_cols <= plan.half_cols \
                        <= 128
                else:
                    assert plan.half_cols == plan.d8
                assert (blocks // plan.halves - 1) * plan.rows < T \
                    <= blocks // plan.halves * plan.rows
                if T == 2048 and D % 64:
                    continue   # the cover check at small T suffices
                seen = [cell for _, cells in _general_cells(kernel, plan, T,
                                                            D)
                        for cell in cells]
                assert len(seen) == len(set(seen)) == T * plan.d8
    # D 256: G1 the 64 q rows, a 32-row k and a v tile; G2 the 64 k and v
    # rows, a 32-row q and a dO tile and the q tile's 32 lse and delta
    # values; G3 the 64 q and dO rows, a 32-row k and a v tile; row stride
    # 260 f32 (1040 bytes, 16 x 65); each 1 KiB of slack, which the last
    # group of p.v (dk, dv; ds.k) tiles may read into.
    want = {"flash_fwd_general": (64 + 2 * 32) * 260 * 4 + 1024,
            "flash_bwd_dkdv_general": (2 * 64 + 2 * 32) * 260 * 4
            + 2 * 32 * 4 + 1024,
            "flash_bwd_dq_general": (2 * 64 + 2 * 32) * 260 * 4 + 1024}
    assert _cuda.general_plan(kernel, 8, 16, 2048, 256).smem_bytes == \
        want[kernel]


@pytest.mark.parametrize("kernel,want", [
    # D 128 in f32: row stride 132 (528 bytes, 16 x 33); G1 three blocks
    # an SM, G2 and G3 two.
    ("flash_fwd_general", ((64 + 2 * 32) * 132 * 4 + 1024, 32, 1,
                           (32, 16, 8))),
    ("flash_bwd_dkdv_general", ((2 * 64 + 2 * 32) * 132 * 4 + 256 + 1024,
                                32, 1, (32, 16, 8))),
    ("flash_bwd_dq_general", ((2 * 64 + 2 * 32) * 132 * 4 + 1024, 32, 1,
                              (32, 16, 8))),
])
def test_general_plan_at_the_training_shape(kernel, want):
    plan = _cuda.general_plan(kernel, 8, 16, 2048, 128)
    assert (plan.smem_bytes, plan.tile, plan.halves, plan.grid) == want
    assert (plan.d8, plan.ld, plan.copy_bytes) == (128, 132, 16)
    blocks = 3 if kernel == "flash_fwd_general" else 2
    assert blocks * (plan.smem_bytes + 1024) <= 233_472


def _banks_conflict_free(offsets, itemsize):
    """Whether one shared load whose 32 lanes read these element offsets
    runs in one pass: no two different 4-byte words on one bank."""
    words = {off * itemsize // 4 for off in offsets}
    banks = [w % 32 for w in words]
    return len(banks) == len(set(banks))


@pytest.mark.parametrize("D", (1, 8, 12, 13, 64, 80, 100, 128, 129, 200,
                               256))
@pytest.mark.parametrize("dtype", GEN_DTYPES)
def test_general_fragment_loads_hit_distinct_banks(dtype, D):
    """Every fragment load of G1-G3, from the plan's row stride: the A
    fragment (rows g, g + 8 at columns t, t + 4) and the B fragment of a
    product with a tile's transpose (row g at columns t, t + 4) read q
    and k (G1), k, v, q and dO (G2) or q, dO, k and v (G3: A of q.k^T and
    dO.v^T, B of both), in f32 as ldmatrix (each 8 x 4 block's 8 rows of
    16 bytes); the B fragment of a product with the tile (rows 2t, 2t + 1
    at column g) reads v (G1), dO and q (G2) or k (G3, ds.k).  In f32 the
    32 lanes reach 32 distinct banks; in fp16/bf16 two lanes share each
    word and the 16 words reach 16 banks."""
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]
    for kernel in GENERAL:
        plan = _cuda.general_plan(kernel, 2, 2, 256, D, dtype)
        ld, es = plan.ld, dtype.itemsize
        assert ld * es % 32 == 16 and ld >= plan.d8
        for c0 in range(0, plan.d8, 8):
            loads = [[(g + dr) * ld + c0 + t + dc for g, t in lanes]
                     for dr in (0, 8) for dc in (0, 4)]
            loads += [[(2 * t + dr) * ld + c0 + g for g, t in lanes]
                      for dr in (0, 1)]
            if es == 4:   # ldmatrix: rows r of 4 words each
                loads += [[r * ld + c0 + dc + w for r in range(8)
                           for w in range(4)] for dc in (0, 4)]
            for offsets in loads:
                assert _banks_conflict_free(offsets, es), (kernel, c0)
                if es == 4:
                    assert len({o % 32 for o in offsets}) == 32


def _csrc_constant(name):
    """An ``int`` constant of ``csrc/flash_general.cu``."""
    text = (_cuda.CSRC / "flash_general.cu").read_text()
    m = re.search(rf"constexpr int {name} = (\d+);", text)
    assert m, name
    return int(m.group(1))


@pytest.mark.parametrize("kernel", GENERAL)
def test_general_row_products_read_inside_shared_memory(kernel):
    """``product_rows`` (o += p.v in G1, dk += ds^T q and dv += p^T dO in
    G2, dq += ds.k in G3) takes the 8-column tiles of its shared tile in
    groups of ``kTileGroup`` and lets the last group read past the
    tile's columns instead of clamping; those reads, rows 0-31 at columns
    up to the group's end, must stay inside the block's shared memory (the
    tile that is read is the last one, or is followed by lse and delta,
    and then ``kTcSlack`` bytes)."""
    group = _csrc_constant("kTileGroup")
    assert _csrc_constant("kTcSlack") == _cuda._TC_SLACK
    for dtype in GEN_DTYPES:
        es = dtype.itemsize
        for D in range(1, _cuda.GENERAL_MAX_D + 1):
            plan = _cuda.general_plan(kernel, 1, 1, 64, D, dtype)
            ld = plan.ld
            if kernel == "flash_bwd_dkdv_general":
                # dv reads the dO tile, the last, at each half's columns.
                start = (2 * 64 + 32) * ld
                halves = [(h * plan.half_cols,
                           (plan.d8 - plan.half_cols if h else
                            plan.half_cols) // 8)
                          for h in range(plan.halves)]
            else:   # G1 reads its v tile, G3 its k tile: the last
                own = 64 if kernel == "flash_fwd_general" else 128
                start, halves = (own + 32) * ld, [(0, plan.d8 // 8)]
            for c0, n_tiles in halves:
                last = (n_tiles - 1) // group * group
                end = start + c0 + 31 * ld + 8 * (last + group)
                assert end * es <= plan.smem_bytes, (dtype, D, c0)


def _row_starts(x, D, H):
    """Byte address of every head's row start in a (B, T, H*D) view."""
    sb, st, _ = x.stride()
    es = x.element_size()
    return {x.data_ptr() + (b * sb + r * st + h * D) * es
            for b in range(x.shape[0]) for r in range(x.shape[1])
            for h in range(H)}


def _views(dtype, D, H):
    B, T, C = 2, 5, H * D
    whole = torch.empty((B, T, C), dtype=dtype)
    fused = torch.empty((B, T, 3 * C), dtype=dtype)
    return {"whole": whole,
            "fused k": fused[..., C:2 * C],
            "padded row": torch.empty((B, T, C + 1), dtype=dtype)[..., :C],
            "offset start": torch.empty((B, T, C + 1), dtype=dtype)[..., 1:],
            "every other row": fused[:, ::2, :C]}


@pytest.mark.parametrize("D", (1, 2, 4, 8, 12, 13, 64, 80, 128, 200))
@pytest.mark.parametrize("dtype", GEN_DTYPES)
def test_general_copy_width_follows_row_alignment(dtype, D):
    """G1-G3 stage with 16-byte copies only where every row start of every
    operand is 16-byte aligned, else 4-byte copies where every row start
    is 4-byte aligned, else one element at a time; the slowest operand
    sets the width."""
    H = 3
    es = dtype.itemsize
    views = _views(dtype, D, H)
    widths = {}
    for name, x in views.items():
        starts = _row_starts(x, D, H)
        want = next((w for w in (16, 4) if all(a % w == 0 for a in starts)),
                    es)
        for kernel in GENERAL:
            plan = _cuda.general_plan(kernel, 2, H, 5, D, dtype,
                                      [(x.stride(), x.data_ptr())])
            assert plan.copy_bytes == want, (name, kernel)
        widths[name] = want
    for kernel in GENERAL[1:]:   # the backwards read q, k, v and dO
        together = _cuda.general_plan(
            kernel, 2, H, 5, D, dtype,
            [(x.stride(), x.data_ptr()) for x in views.values()])
        assert together.copy_bytes == min(widths.values())


@pytest.mark.parametrize("dtype,D,want", [
    *[(torch.bfloat16, d, "hopper") for d in (16, 64, 80, 128)],
    *[(dt, d, "general") for dt in (torch.float32, torch.float16)
      for d in (8, 12, 128, 256)],
    *[(torch.bfloat16, d, "general") for d in (8, 12, 200)],
])
def test_flash_family_follows_dtype_and_head_size(dtype, D, want):
    """The rule that picks the kernels, fixed in advance on the input:
    bf16 at a multiple of 16 in [16, 128] takes P1/P2/P3/P6, f32 and fp16
    at any head size up to 256 and bf16 at the others take G1-G3."""
    x = torch.empty((2, 24, 3 * 2 * D), dtype=dtype)[..., 2 * D:4 * D]
    assert _cuda.flash_family(dtype, D, x.stride(), x.data_ptr()) == want


@pytest.mark.parametrize("dtype,D", [(torch.float32, 257),
                                     (torch.bfloat16, 257)])
def test_flash_family_takes_head_sizes_over_256_on_the_wide_route(dtype, D):
    """D 257 (which raised before the wide route) takes W1-W3, in every
    dtype, whatever the strides the general family takes."""
    strides = (24 * 2 * D, 2 * D, 1)
    assert _cuda.flash_family(dtype, D, strides, 0) == "wide"


@pytest.mark.parametrize("dtype,D,strides,ptr,match", [
    (torch.float32, _cuda.WIDE_MAX_D + 1, (24 * 2 ** 15, 2 ** 15, 1), 0,
     f"from 1 to {_cuda.WIDE_MAX_D}"),
    (torch.float16, 0, (24, 1, 1), 0, f"from 1 to {_cuda.WIDE_MAX_D}"),
    (torch.float32, 8, (48, 16, 2), 0, "unit column stride"),
    (torch.bfloat16, 64, (24 * 129, 129, 1), 0, "multiples of 8"),
    (torch.bfloat16, 64, (24 * 128, 128, 1), 8, "16-byte aligned"),
    (torch.float64, 64, (24 * 128, 128, 1), 0, "float32, float16 or"),
])
def test_flash_family_refuses_what_no_kernel_takes(dtype, D, strides, ptr,
                                                   match):
    with pytest.raises(ValueError, match=match):
        _cuda.flash_family(dtype, D, strides, ptr)


@pytest.mark.parametrize("D", HEAD_SIZES)
def test_tma_strides_are_16_byte_multiples(D):
    """For every view the wrappers accept (a whole tensor, the q/k/v column
    regions of a fused projection, a padded row stride), the tensor map's
    byte strides are multiples of 16."""
    B, T, H = 2, 24, 3
    C = H * D
    views = [torch.empty((B, T, C), dtype=torch.bfloat16),
             torch.empty((B, T, 3 * C), dtype=torch.bfloat16)[..., C:2 * C],
             torch.empty((B, T, C + 8), dtype=torch.bfloat16)[..., :C],
             torch.empty((B, T, 3 * C), dtype=torch.bfloat16)[:, ::2, :C]]
    accepted = [x for x in views
                if _cuda.kernel_strides_ok(x.stride(), x.data_ptr())]
    assert len(accepted) == len(views)
    for x in accepted:
        sb, st, _ = x.stride()
        assert all(s % 16 == 0 for s in _cuda.tma_strides(D, st, sb))
    # A view the wrappers refuse: an odd row stride.
    odd = torch.empty((B, T, C + 1), dtype=torch.bfloat16)[..., :C]
    assert not _cuda.kernel_strides_ok(odd.stride(), odd.data_ptr())


@pytest.mark.parametrize("shape,heads,D", [((1, 64, 771), 3, 257),
                                            ((1, 64, 600), 2, 300)])
def test_wrapper_takes_head_sizes_over_256(shape, heads, D):
    """The geometry checks before a launch take the head sizes that raised
    before the wide route (D 257 and 300)."""
    q = torch.zeros(shape, dtype=torch.bfloat16)
    assert _cuda._geometry(q, heads, None)[4] == D


@pytest.mark.parametrize("shape,heads,seq_len,match", [
    ((1, 4, 2 * (_cuda.WIDE_MAX_D + 1)), 2, None,
     f"head size from 1 to {_cuda.WIDE_MAX_D}"),
    ((1, 64, 100), 3, None, "not a multiple of num_heads"),
    ((1, 64, 128), 2, 65, "out of range"),
    ((1, 64, 128), 2, 0, "out of range"),
    ((64, 128), 2, None, "must be"),
])
def test_wrapper_errors_are_unchanged(shape, heads, seq_len, match):
    """The checks before any launch raise as before the Hopper kernels;
    the head size may now be anything up to ``WIDE_MAX_D`` (the general
    family and its wide route)."""
    q = torch.zeros(shape, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        _cuda._geometry(q, heads, seq_len)


def test_ablation_edits_apply_to_the_kernels():
    """``flash_ablation.py`` times P1, P2, P3, P6 and G1-G3 against text
    edits of their committed sources; each edit must still find its text
    exactly once."""
    spec = importlib.util.spec_from_file_location(
        "flash_ablation", ROOT / "flash_ablation.py")
    ablation = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ablation)
    assert {v for _, v in ablation.EDITS} == {
        "no reload", "no softmax", "heads first", "no dq sum", "no dq",
        "one product", "no B split", "cvt.rna split", "always clamp",
        "sum sets 1"}
    assert {stem for stem, _ in ablation.EDITS} == set(KERNELS) | {
        "flash_general"}
    for (stem, variant), edits in ablation.EDITS.items():
        text = (_cuda.CSRC / f"{stem}.cu").read_text()
        for old, new in edits:
            assert text.count(old) == 1, (stem, variant, old[:40])
            text = text.replace(old, new)


WIDE = ("flash_fwd_wide", "flash_bwd_dkdv_wide", "flash_bwd_dq_wide")


@pytest.mark.parametrize("kernel", WIDE)
def test_wide_route_fits_shared_memory_up_to_its_limit(kernel):
    """W1-W3 hold their own rows and accumulators, D floats each, in
    dynamic shared memory beside the static tiles each kernel declares: at
    ``WIDE_MAX_D`` every one fits an H100 block, static and dynamic bytes
    together, and one more column does not fit W2.  The rows each holds
    are the entry point's (``flash_wide.cu`` ``wide_smem_bytes``), and the
    static bytes are counted from each kernel's ``__shared__`` arrays."""
    text = (_cuda.CSRC / "flash_wide.cu").read_text()
    m = re.search(r"const int rows = kernel == 0 \? (\d+) : kernel == 1 \? "
                  r"(\d+) : (\d+);", text)
    assert m
    rows = dict(zip(WIDE, (int(m.group(i)) for i in (1, 2, 3))))
    tile = int(re.search(r"constexpr int kWideTile = (\d+);", text).group(1))
    static = {}
    for name in WIDE:
        body = text[text.index(f"{name}_kernel(const WideParams<E> p)"):]
        body = body[:body.index("\n}\n")]
        decls = re.findall(r"(?<!extern )__shared__ float ([^;]+);", body)
        arrays = [a for d in decls for a in d.split(",")]
        assert all(a.strip().endswith("[kWideTile]") for a in arrays)
        static[name] = 4 * tile * len(arrays)
    assert max(static.values()) == _cuda.WIDE_STATIC_SMEM
    for D in (257, 384, 1000, _cuda.WIDE_MAX_D):
        assert _cuda.wide_smem_bytes(kernel, D) == 4 * rows[kernel] * D
        assert (_cuda.wide_smem_bytes(kernel, D) + static[kernel]
                <= _cuda.SMEM_LIMIT)
    assert (_cuda.wide_smem_bytes("flash_bwd_dkdv_wide", _cuda.WIDE_MAX_D + 1)
            + static["flash_bwd_dkdv_wide"] > _cuda.SMEM_LIMIT)
