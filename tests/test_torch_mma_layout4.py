"""`conv_kernel`'s pooled epilogue (kConvPool): its index arithmetic on the
CPU.

Continues `tests/test_torch_mma_layout.py`, whose transliteration of
`csrc/conv_tile.cuh` (`ConvEmu`) and of `csrc/mma_tile.cuh`'s epilogues it
uses. A layer that a 2×2 max-pool follows runs its tile's pixels window by
window: tile pixel 4q + s is position s of the window of pooled pixel q,
the input rows a tile needs are one span counted in pairs of output rows,
two exchanges between lanes 4 and 8 apart leave each window's largest
accumulator in one lane of four, and that lane thresholds and stores it.
Here: the tile's pixels, spans and row bound at CNV's two pooled layers
(conv1, conv4) at batch 1024 and at a ragged batch of 3; the lane pairs of
the two exchanges and the one store of each pooled code; and the whole
kernel, statement by statement, against `conv_chain_plain(pool=True)`.
Integer codes throughout: every comparison exact.
"""

import numpy as np
import pytest
import torch

from bnn_pynq_tpu_torch.models.params import weight_matrix
from bnn_pynq_tpu_torch.ops import conv_stack
from tests.test_torch_mma_layout import (ITEM_COLS, ITEM_ROWS, LANES,
                                         MAX_SMEM, ConvEmu, _layers, _port,
                                         emu_conv_chain, pool_windows,
                                         pooled_stores)

# CNV's pooled layers: (input h, c, n, the launcher's tile and warps)
CNV_POOLED = {"conv1": (30, 64, 64, 512, 16), "conv4": (12, 128, 128, 128, 8)}


def _emu(h, c, n, batch=2):
    x = np.zeros((batch, h, h, c), np.int8)
    w = weight_matrix(torch.zeros((9 * c, n), dtype=torch.int8))
    return ConvEmu(x, 3, False, w, torch.zeros((1, n), dtype=torch.int32), 1,
                   pool=True)


@pytest.mark.parametrize("layer", list(CNV_POOLED))
def test_cnv_pooled_tiles_fit_shared_memory(layer):
    """The launcher's sizing at CNV's pooled layers: the whole weight set
    staged once, no staging buffers, the same tile and warps as the
    unpooled layer (conv1 two blocks' worth of warps in one, since two
    blocks of 8 would not fit an SM beside their reserved shared memory)."""
    h, c, n, tile, warps = CNV_POOLED[layer]
    emu = _emu(h, c, n)
    assert (emu.tile, emu.warps, emu.n_chunk) == (tile, warps, n)
    assert emu.halo and emu.smem_bytes <= MAX_SMEM


@pytest.mark.parametrize("batch", [1024, 3])
@pytest.mark.parametrize("layer", list(CNV_POOLED))
def test_cnv_pooled_pixels_read_their_windows_and_are_written_once(layer,
                                                                   batch):
    """Every tile pixel 4q + s addresses, through the staged span, the
    input under output pixel (2·pr + s / 2, 2·pc + s % 2) of pooled pixel q
    = (image, pr, pc); the span of each tile lies within max_tile_rows; the
    items' stores cover each pooled pixel exactly once, the ragged last
    tile and item included."""
    h, c, n, tile, _ = CNV_POOLED[layer]
    emu = _emu(h, c, n, batch=batch)
    oh = ow = h - 2
    ph, pw = oh // 2, ow // 2
    pixels = batch * oh * ow
    p = np.arange(pixels)
    q, s = p // 4, p % 4
    img, pr, pc = np.unravel_index(q, (batch, ph, pw))
    oy, ox = 2 * pr + s // 2, 2 * pc + s % 2
    row, col = emu.input_row_of(p), emu.column_of(p)
    np.testing.assert_array_equal(row, img * h + oy)
    np.testing.assert_array_equal(col, ox)
    # each window's four pixels are four distinct output pixels
    flat = (img * oh + oy) * ow + ox
    assert len(np.unique(flat)) == pixels

    p0 = (p // tile) * tile
    p1 = np.minimum(p0 + tile, pixels) - 1
    first = emu.input_row_of(p0)
    count = emu.input_row_of(p1) + 3 - first
    assert (count <= emu.max_tile_rows()).all()
    # the pixel's taps, rows row .. row + 2 at columns col .. col + 2, lie in
    # the staged span: pix_off = ((row - first) · w + col) · pitch
    assert (row >= first).all() and (row + 2 < first + count).all()
    assert (col + 2 < h).all()

    written = np.zeros(pixels // 4, np.int64)
    for t0 in range(0, pixels, tile):
        t1 = min(t0 + tile, pixels) - 1
        assert t0 % 4 == 0 and (t1 + 1) % 4 == 0, "a tile splits a window"
        for m0 in range(0, t1 - t0 + 1, ITEM_ROWS):
            rows = min(ITEM_ROWS, t1 - t0 + 1 - m0)
            win0, windows = (t0 + m0) // 4, rows // 4
            written[win0:win0 + windows] += 1
    assert (written == 1).all()


def test_pool_exchanges_pair_each_windows_rows():
    """The lanes 4 and 8 apart hold rows of the same window (g, g + 8 of an
    m16 block: window g / 4, 2 + g / 4); after the two exchanges each
    (window, column) of an item's m16 block is stored by exactly one lane,
    with the largest of its window's four accumulators."""
    g = LANES >> 2
    for step in (4, 8):
        assert ((g >> 2) == (g[LANES ^ step] >> 2)).all()
    rng = np.random.default_rng(26)
    acc = rng.integers(-2 ** 20, 2 ** 20, size=(2, 8, 32, 4))
    acc[:, :, 5, 1] = acc[:, :, 4, 1]                   # ties in a window
    # acc as item rows × columns: row 16·mb + 8·h + g, column 8·j + 2·t + c
    t = LANES & 3
    dense = np.empty((ITEM_ROWS, ITEM_COLS), np.int64)
    for mb in range(2):
        for j in range(8):
            for e in range(4):
                h, c = divmod(e, 2)
                dense[16 * mb + 8 * h + g, 8 * j + 2 * t + c] = \
                    acc[mb, j, :, e]
    want = dense.reshape(8, 4, ITEM_COLS).max(axis=1)     # [window, column]
    for s in range(4):       # each window position holds some maximum
        assert (want == dense[s::4]).any()
    got = np.full((8, ITEM_COLS), np.iinfo(np.int64).min)
    stores = np.zeros((8, ITEM_COLS), np.int64)
    for mb in range(2):
        pool_windows(acc, mb)        # in place: blocks 0 and 4 of the lane's
        for k in range(2):
            for h in range(2):
                w, n = pooled_stores(mb, k, h)
                for c in range(2):
                    got[w, n + c] = acc[mb, 4 * k, :, 2 * h + c]
                    np.add.at(stores, (w, n + c), 1)
    assert (stores == 1).all()
    np.testing.assert_array_equal(got, want)


POOLED_CASES = {
    # name: (wbits, abits, b, h, kernel, channels, input_levels, tile, grid)
    "w1a1 halo, ragged last tile": (1, 1, 3, 8, 3, [32, 24], False, 32, 3),
    "w2a2 halo, two buffers, N=72": (2, 2, 2, 10, 3, [64, 72], False, 32, 2),
    "w1a2 chain of 2, pooled last": (1, 2, 1, 10, 3, [32, 32, 64], False,
                                     64, 2),
    "w1a1 image C=3 (gathered)": (1, 1, 2, 8, 3, [3, 16], True, None, 2),
    "w1a1 tile across images": (1, 1, 5, 6, 3, [32, 8], False, 64, 1),
    "w4a4 1x1, 15 thresholds searched": (4, 4, 2, 6, 1, [32, 72], False,
                                         32, 2),
}


@pytest.mark.parametrize("case", list(POOLED_CASES))
def test_pooled_conv_kernel_arithmetic_equals_plain(case):
    wbits, abits, b, h, k, chans, levels, tile, grid = POOLED_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    ws, ts = _layers(rng, chans, wbits, abits, k=k, image=levels)
    if levels:
        x = rng.integers(-128, 128, size=(b, h, h, chans[0]))
    else:
        x = rng.integers(0, 2 ** abits, size=(b, h, h, chans[0]))
    x = torch.from_numpy(x.astype(np.int8))
    pw, pt = _port(ws, ts)
    want = conv_stack.conv_chain_plain(x, pw, pt, kernel=k, abits=abits,
                                       input_levels=levels, pool=True)
    got = emu_conv_chain(x, pw, pt, kernel=k, abits=abits,
                         input_levels=levels, tile=tile, grid=grid, pool=True)
    assert len(np.unique(want.numpy())) > 1, "a degenerate case"
    np.testing.assert_array_equal(got, want.numpy())
