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


@pytest.mark.parametrize("kernel", GENERAL)
def test_general_plan_fits_the_card_and_covers_every_row(kernel):
    """G1-G3: one block of 128 threads per 16 rows of a head; the staged
    f32 tiles fit in shared memory at every head size up to 256, with an
    odd row stride (32 lanes reading 32 rows hit 32 banks)."""
    B, H = 2, 3
    for D in range(1, _cuda.GENERAL_MAX_D + 1):
        for T in (1, 15, 16, 17, 200, 2048):
            plan = _cuda.general_plan(kernel, B, H, T, D)
            blocks, heads, batches = plan.grid
            assert (heads, batches, plan.threads) == (H, B, 128)
            assert (blocks - 1) * 16 < T <= blocks * 16
            assert plan.ld % 2 == 1 and D <= plan.ld <= D + 1
            assert plan.smem_bytes <= _cuda.SMEM_LIMIT
    # D 256 in f32: G1 the 16 q rows and a 32-row k and v tile; G2 and G3
    # 16 + 16 own rows and two 32-row tiles (G2 with 32 lse and delta).
    want = {"flash_fwd_general": (16 + 64) * 257 * 4,
            "flash_bwd_dkdv_general": 2 * (16 + 32) * 257 * 4 + 256,
            "flash_bwd_dq_general": 2 * (16 + 32) * 257 * 4}
    assert _cuda.general_plan(kernel, 8, 16, 2048, 256).smem_bytes == \
        want[kernel]


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


@pytest.mark.parametrize("dtype,D,strides,ptr,match", [
    (torch.float32, 257, (24 * 514, 514, 1), 0, "from 1 to 256"),
    (torch.bfloat16, 257, (24 * 514, 514, 1), 0, "from 1 to 256"),
    (torch.float16, 0, (24, 1, 1), 0, "from 1 to 256"),
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


@pytest.mark.parametrize("shape,heads,seq_len,match", [
    ((1, 64, 771), 3, None, "head size from 1 to 256"),
    ((1, 64, 600), 2, None, "head size from 1 to 256"),
    ((1, 64, 100), 3, None, "not a multiple of num_heads"),
    ((1, 64, 128), 2, 65, "out of range"),
    ((1, 64, 128), 2, 0, "out of range"),
    ((64, 128), 2, None, "must be"),
])
def test_wrapper_errors_are_unchanged(shape, heads, seq_len, match):
    """The checks before any launch raise as before the Hopper kernels;
    the head size may now be anything up to 256 (the general family)."""
    q = torch.zeros(shape, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        _cuda._geometry(q, heads, seq_len)


def test_ablation_edits_apply_to_the_kernels():
    """``flash_ablation.py`` times P1, P2, P3 and P6 against text edits of
    their committed sources; each edit must still find its text exactly
    once."""
    spec = importlib.util.spec_from_file_location(
        "flash_ablation", ROOT / "flash_ablation.py")
    ablation = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ablation)
    assert {v for _, v in ablation.EDITS} == {
        "no reload", "no softmax", "heads first", "no dq sum", "no dq"}
    assert {stem for stem, _ in ablation.EDITS} == set(KERNELS)
    for (stem, variant), edits in ablation.EDITS.items():
        text = (_cuda.CSRC / f"{stem}.cu").read_text()
        for old, new in edits:
            assert text.count(old) == 1, (stem, variant, old[:40])
            text = text.replace(old, new)
