"""The host side of the 3x3 conv kernel (``nbdt_torch/ops/conv3x3.py``):
``plan_conv3x3``, ``pack_weight``, and a plain walk of the plan that repeats
the kernel's index arithmetic on the CPU. The walk builds each tile's
zero-filled, pitch-34 window as the kernel's TMA box lands in shared memory,
takes each tap's ``[64 x 4*34]`` product from the start offset
``dy*34 + dx`` of the flattened window, drops the pad columns and writes the
tile; pixels past the window's end read NaN, as stale shared memory could,
and must reach only dropped columns. It is held to the plain version
at torch.testing.assert_close's bf16 defaults (f32 sums in another order,
one rounding to bf16)."""

import numpy as np
import pytest
import torch

from nbdt_torch.ops import conv3x3 as conv

SMS = 132  # an H100 SXM
SHAPES = [(8192, 32, 32), (5, 7, 5), (3, 6, 33), (1, 1, 1), (1, 9, 64), (2, 33, 70)]
WALK_SHAPES = [(2, 32, 32), (5, 7, 5), (3, 6, 33), (1, 1, 1), (1, 9, 64), (2, 33, 70)]


def _tiles(plan, N, H, W):
    """(n, h0, w0) of every tile index, as the kernel's ``tile_at`` decodes it."""
    t = np.arange(plan.tiles)
    bands = -(-H // plan.band_rows)
    per_image = bands * plan.col_tiles
    rem = t % per_image
    return (t // per_image, (rem // plan.col_tiles) * plan.band_rows,
            (rem % plan.col_tiles) * conv.TILE_W)


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_fits_the_card(shape):
    """Shared memory within the H100's 232,448 bytes, a window that holds
    the tile's 32 columns and their halo with wgmma's N = rows x pitch a
    multiple of 8 (the kernel's B may start on any 128-byte row, so the pitch
    itself need not be), at least two stages, at most one block an SM."""
    plan = conv.plan_conv3x3(*shape, SMS)
    assert plan.smem_bytes <= conv.SMEM_LIMIT
    assert plan.smem_bytes == conv.smem_bytes(plan.stages)
    assert plan.pitch >= conv.TILE_W + 2 and plan.band_rows * plan.pitch % 8 == 0
    assert plan.band_rows * plan.pitch <= 256  # the widest wgmma
    assert 1 <= plan.grid <= min(SMS, plan.tiles)
    assert plan.stages >= 2 and plan.col_tiles == -(-shape[2] // conv.TILE_W)


@pytest.mark.parametrize("shape", SHAPES)
def test_tiles_cover_every_pixel_once(shape):
    """Every output pixel is written by exactly one tile, and the persistent
    blocks walk every tile once."""
    N, H, W = shape
    plan = conv.plan_conv3x3(N, H, W, SMS)
    n, h0, w0 = _tiles(plan, N, H, W)
    hits = np.zeros((N, H, W), np.int32)
    for r in range(plan.band_rows):
        for c in range(conv.TILE_W):
            h, w = h0 + r, w0 + c
            keep = (h < H) & (w < W)  # the TMA store clips these
            np.add.at(hits, (n[keep], h[keep], w[keep]), 1)
    assert (hits == 1).all()
    walked = np.concatenate([np.arange(b, plan.tiles, plan.grid) for b in range(plan.grid)])
    assert np.array_equal(np.sort(walked), np.arange(plan.tiles))


def test_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        conv.plan_conv3x3(4, 32, 32, SMS, smem_limit=100_000)
    with pytest.raises(ValueError, match="no launch"):
        conv.plan_conv3x3(0, 32, 32, SMS)


def test_pack_weight_is_the_hwio_weight():
    w = torch.from_numpy(np.random.RandomState(0).randn(3, 3, 64, 64).astype(np.float32)).bfloat16()
    wpk = conv.pack_weight(w)
    assert wpk.shape == (64, 576) and wpk.is_contiguous() and wpk.dtype == torch.bfloat16
    for dy in range(3):
        for dx in range(3):
            tap = dy * 3 + dx
            assert torch.equal(wpk[:, tap * 64:(tap + 1) * 64], w[dy, dx].t())


def _walk(x, w, b, plan):
    """The kernel's arithmetic, tile by tile, in f32 on the bf16 values."""
    N, H, W, C = x.shape
    wpk = conv.pack_weight(w.bfloat16()).float()
    xf = x.float()
    y = torch.full((N, H, W, C), float("nan"))
    rows, P = plan.band_rows + 2, plan.pitch
    n_t, h0_t, w0_t = _tiles(plan, N, H, W)
    for n, h0, w0 in zip(n_t.tolist(), h0_t.tolist(), w0_t.tolist()):
        win = torch.zeros(rows, P, C)  # the TMA box at (0, w0-1, h0-1, n), zero outside x
        hs, ws = max(h0 - 1, 0), max(w0 - 1, 0)
        he, we = min(h0 - 1 + rows, H), min(w0 - 1 + P, W)
        win[hs - (h0 - 1):he - (h0 - 1), ws - (w0 - 1):we - (w0 - 1)] = xf[n, hs:he, ws:we]
        flat = torch.cat([win.reshape(rows * P, C), torch.full((P, C), float("nan"))])
        R = plan.band_rows
        acc = torch.zeros(C, R * P)  # D[co, pixel], wgmma N = rows x pitch
        for tap in range(conv.TAPS):
            dy, dx = divmod(tap, 3)
            s = dy * P + dx
            acc += wpk[:, tap * C:(tap + 1) * C] @ flat[s:s + R * P].t()
        out = (acc + b[:, None]).relu().bfloat16().t().reshape(R, P, C)
        out = out[:, :conv.TILE_W]  # the store's box drops the pad columns
        hh, ww = min(R, H - h0), min(conv.TILE_W, W - w0)
        y[n, h0:h0 + hh, w0:w0 + ww] = out[:hh, :ww].float()
    return y.bfloat16()


@pytest.mark.parametrize("shape", WALK_SHAPES)
def test_plain_walk_of_the_plan_matches_the_plain_version(shape):
    N, H, W = shape
    rng = np.random.RandomState(N * 1000 + H * 10 + W)
    x = torch.from_numpy(rng.randn(N, H, W, 64).astype(np.float32)).bfloat16()
    w = torch.from_numpy((rng.randn(3, 3, 64, 64) * 0.05).astype(np.float32))
    b = torch.from_numpy((rng.randn(64) * 0.01).astype(np.float32))
    plan = conv.plan_conv3x3(N, H, W, SMS)
    got = _walk(x, w, b, plan)
    assert not torch.isnan(got.float()).any()
    torch.testing.assert_close(got, conv.conv3x3_bias_relu_reference(x, w, b))


def test_ablation_variants_build_from_the_kernel_source():
    """Every variant of ``python -m nbdt_torch.tools.conv3x3_ablation`` finds
    the text it edits in ``csrc/conv3x3.cu``, and the wgmma it generates for
    another N has the kernel's own instruction template."""
    import re

    from nbdt_torch.ops import _build
    from nbdt_torch.tools import conv3x3_ablation as ab

    kernel = (_build.CSRC / "conv3x3.cu").read_text()
    sources = {name: ab.variant_source(name) for name in ab.VARIANTS}
    assert sources["kernel"] == kernel
    assert len(set(sources.values())) == len(sources)

    def template(src, n):
        body = src[src.index(f"void wgmma_m64n{n}k16("):]
        return "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', body[:body.index(': "+f"')]))

    assert template(ab._wgmma_source(136), 136) == template(kernel, 136)
    assert "m64n160k16" in template(sources["pitch40"], 160)
