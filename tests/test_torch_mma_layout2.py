"""`conv2d_direct` and `fused_mlp` on the tensor cores: their index arithmetic
on the CPU.

Continues `tests/test_torch_mma_layout.py` (whose fragment, ldmatrix and
epilogue transliterations it imports) for the two kernels that followed
`conv_chain` and `dense_block` onto `mma.sync`:

- `csrc/conv_direct.cu::bnn_conv_direct`: the conv kernel of
  `csrc/conv_tile.cuh` with its int32 epilogue (`item_store_acc`, the true
  accumulator 2·acc − off·wsum), the column chunks on the grid's second
  axis, the hand-off of a conv whose kernel covers its input to the dense
  kernel, and the stride form (a 1×1 conv over patches padded to k32
  channels);
- `csrc/dense_chain.cu::mlp_kernel`: the weights' swizzled K tiles
  (`WeightMatrix.tiles`) and the ldmatrix addresses that undo the swizzle,
  the ring of tiles that runs across column passes and layers (a tile is
  asked for when the stage two behind is consumed), the two activation
  tiles and their pitch, the column split across warps, the folded
  thresholds of every layer, the true-accumulator last layer.

Statement by statement in numpy, shared memory starting as garbage,
thresholds within one standard deviation of the accumulator, every
comparison exact (the logits too: both sides round twice in float32).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bnn_pynq_tpu.ops.conv_direct import conv2d_direct as jax_conv2d_direct
from bnn_pynq_tpu.ops.fused_mlp import \
    fused_mlp_forward_padded as jax_fused_mlp
from bnn_pynq_tpu_torch.models.params import weight_matrix
from bnn_pynq_tpu_torch.ops import conv_direct, fused_mlp
from bnn_pynq_tpu_torch.ops.conv import sliding_window
from tests.test_torch_mma_layout import (ITEM_COLS, ITEM_ROWS, LANES,
                                         MAX_SMEM, MMA_K,
                                         STAGE_PITCH, VEC, WARPS, ConvEmu,
                                         _jax, _layers, _port, a_lane_k,
                                         a_lane_row, b_lane_col, b_lane_k,
                                         item_store_codes,
                                         ldmatrix_x4, mma_s8, padded_pitch,
                                         round_up, stage_thresholds)

# csrc/dense_chain.cu
MLP_ROWS, MLP_SLICE, MLP_STAGES = ITEM_ROWS, 128, 3
STAGE_BYTES = 16 * STAGE_PITCH


# -- conv_direct.cu::bnn_conv_direct --------------------------------------------

def emu_conv2d_direct(x, w, thr, *, kernel, abits, stride=1, tile=None,
                      grid=3, room=6):
    """The wrapper's stride form, the entry's hand-off and the conv kernel."""
    x = x.numpy()
    if stride != 1:                       # ops/conv_direct.py
        k32 = w.nk32.shape[1]
        x = sliding_window(torch.from_numpy(x), kernel, kernel,
                           stride).numpy()
        x = np.pad(x, ((0, 0),) * 3 + ((0, k32 - x.shape[-1]),),
                   constant_values=1)     # any code: the weights are zero
        kernel = 1
    b, h, wd, c = x.shape
    n = w.kn.shape[1]
    if thr is not None and h == kernel and wd == kernel:
        # the kernel covers the map: dense_chain.cu's kernel on [b, K²C]
        # rows, one thresholded layer, codes out (bnn_dense_codes)
        rows = MlpEmu(x.reshape(b, kernel * kernel * c), [w], [thr], None,
                      None, abits, out_codes=True).run()
        return rows.reshape(b, 1, 1, n)
    emu = ConvEmu(x, kernel, False, w, thr, abits, tile=tile, grid=grid,
                  room=room)
    return emu.run().reshape(b, h - kernel + 1, wd - kernel + 1, n)


DIRECT_CASES = {
    # name: (wbits, abits, b, h, kernel, cin, cout, stride, thresholds,
    #        tile, grid, room)
    "int32 out, codes in (halo), N=24": (1, 1, 3, 7, 3, 32, 24, 1, False,
                                         32, 3, 6),
    "int32 out, W2A2, N=72, odd n_out=9": (2, 2, 2, 6, 3, 64, 9, 1, False,
                                           32, 2, 6),
    "int32 out, C=3 patches (levels)": (1, 1, 2, 8, 3, 3, 10, 1, False,
                                        32, 2, 6),
    "int32 out, 1x1 output map": (2, 2, 5, 3, 3, 32, 16, 1, False, None,
                                  2, 6),
    "stride 2, C=64 (K=576)": (1, 1, 2, 9, 3, 64, 48, 2, True, 32, 2, 6),
    "stride 2, C=24 (K=216, padded to 224)": (2, 2, 3, 8, 3, 24, 20, 2,
                                              True, 32, 2, 6),
    "stride 2, C=3 (K=27, padded to 32)": (1, 1, 2, 9, 3, 3, 10, 2, True,
                                           None, 2, 6),
    "1x1 output map, thresholds: dense hand-off": (1, 1, 37, 3, 3, 32, 72,
                                                   1, True, None, 2, 6),
    "5x5 on a 5x5 map, W2A2: dense hand-off": (2, 2, 9, 5, 5, 24, 100, 1,
                                               True, None, 2, 6),
    "column chunks on the grid (C=256, N=300)": (1, 1, 1, 5, 3, 256, 300,
                                                 1, True, 32, 1, 64),
    "column chunks in the block (C=256, N=300)": (1, 1, 3, 5, 3, 256, 300,
                                                  1, True, 32, 2, 2),
    "int32 out, column chunks on the grid": (1, 1, 1, 4, 3, 256, 136, 1,
                                             False, 32, 1, 64),
    "C=24 patches, N=100, W2A2, batch 1": (2, 2, 1, 9, 3, 24, 100, 1, True,
                                           None, 2, 6),
}


@pytest.mark.parametrize("case", list(DIRECT_CASES))
def test_conv_direct_arithmetic_equals_plain(case):
    wbits, abits, b, h, k, cin, cout, stride, with_thr, tile, grid, room = \
        DIRECT_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    ws, ts = _layers(rng, [cin, cout], wbits, abits, k=k)
    x = torch.from_numpy(rng.integers(0, 2 ** abits, size=(b, h, h, cin))
                         .astype(np.int8))
    pw, pt = _port(ws, ts)
    thr = pt[0] if with_thr else None
    want = conv_direct.conv2d_direct_plain(x, pw[0], thr, kernel=k,
                                           abits=abits, stride=stride)
    got = emu_conv2d_direct(x, pw[0], thr, kernel=k, abits=abits,
                            stride=stride, tile=tile, grid=grid, room=room)
    assert got.dtype == (np.int8 if with_thr else np.int32)
    assert len(np.unique(want.numpy())) > 1, "a degenerate case"
    np.testing.assert_array_equal(got, want.numpy())


def test_column_chunks_go_on_the_grid_only_with_room():
    """The cases above that name the chunks' place do take it."""
    for case, on_grid in (("column chunks on the grid (C=256, N=300)", True),
                          ("column chunks in the block (C=256, N=300)",
                           False)):
        _, _, b, h, k, cin, cout, _, _, tile, grid, room = DIRECT_CASES[case]
        w = weight_matrix(torch.zeros((k * k * cin, cout), dtype=torch.int8))
        emu = ConvEmu(np.zeros((b, h, h, cin), np.int8), k, False, w,
                      torch.zeros((1, cout), dtype=torch.int32), 1,
                      tile=tile, grid=grid, room=room)
        chunks = -(-cout // emu.n_chunk)
        assert chunks > 1 and emu.grid_y == (chunks if on_grid else 1)


def test_direct_layers_fit_shared_memory():
    """The launcher's sizing at the five conv layers of CNV's direct route
    (batch 1024, 132 SMs): conv1-3 as conv_chain's layers of the same shape;
    conv4's 295 KB of weights in two column chunks of 128 beside a tile of
    64 pixels (at this batch 144 tiles, so a block passes over its tiles
    once per chunk; at batch 256 the chunks go on the grid); conv5 (the
    kernel covers the map: three input rows for every output pixel) leaves
    for the dense kernel, and would be left 16 columns a chunk here."""
    for h, c, n, tile, warps, n_chunk in ((30, 64, 64, 512, 16, 64),
                                          (14, 64, 128, 256, 16, 128),
                                          (12, 128, 128, 128, 8, 128),
                                          (5, 128, 256, 64, 8, 128),
                                          (3, 256, 256, None, 8, 16)):
        x = np.zeros((4, h, h, c), np.int8)
        w = weight_matrix(torch.zeros((9 * c, n), dtype=torch.int8))
        emu = ConvEmu(x, 3, False, w, torch.zeros((1, n), dtype=torch.int32),
                      1, room=132)
        assert emu.halo and emu.n_chunk == n_chunk, (h, c, n)
        assert emu.smem_bytes <= MAX_SMEM
        if tile is None:
            continue
        assert (emu.tile, emu.warps) == (tile, warps), (h, c, n)
        pixels = 1024 * emu.oh * emu.ow
        if h == 5:
            assert -(-pixels // emu.tile) * 2 > 132
            assert -(-pixels // 4 // emu.tile) * 2 <= 132
        for p0 in range(0, 40 * emu.tile, emu.tile):
            p1 = min(p0 + emu.tile, pixels) - 1
            count = emu.input_row_of(p1) + 3 - emu.input_row_of(p0)
            assert count <= emu.max_tile_rows()


# -- dense_chain.cu ---------------------------------------------------------------

def tile_mma(pairs, acc, smem, a0, a1, brow, bx, steps):
    """Up to four k32 steps on one ring tile; step st's chunk of K half h
    lies at ((2·st) ^ bx) · 16 of the lane's weight row."""
    for st in range(MLP_SLICE // MMA_K):
        if st >= steps:
            continue
        a = [ldmatrix_x4(smem, a0 + st * MMA_K),
             ldmatrix_x4(smem, a1 + st * MMA_K)]
        b = [ldmatrix_x4(smem, brow[jp] + (((2 * st) ^ bx[jp]) << 4))
             for jp in range(pairs)]
        for jp in range(pairs):
            for mb in range(2):
                mma_s8(acc[mb, 2 * jp], a[mb], b[jp][:, 0], b[jp][:, 1])
                mma_s8(acc[mb, 2 * jp + 1], a[mb], b[jp][:, 2], b[jp][:, 3])


@pytest.mark.parametrize("k,n", [(27, 10), (784, 256), (2304, 37),
                                 (128, 8), (200, 300)])
def test_k_tiles_layout_round_trips_and_has_no_bank_conflicts(k, n):
    """`WeightMatrix.tiles`: slice-major 128-byte K tiles whose 16-byte
    chunk c of row n lies at position c ^ (n & 7); zero past K. Undoing the
    swizzle gives `nk32` back, and the 8 rows one ldmatrix matrix reads
    (the same chunk of 8 neighbouring rows, at a pitch of 128 bytes) fall
    in 8 different 16-byte bank groups of the 128 that shared memory
    serves at once."""
    rng = np.random.default_rng(k + n)
    w = weight_matrix(torch.from_numpy(
        rng.choice([-3, -1, 1, 3], size=(k, n)).astype(np.int8)))
    k32 = round_up(k, MMA_K)
    slices = -(-k32 // MLP_SLICE)
    tiles = w.tiles.numpy()
    assert tiles.shape == (slices, n, MLP_SLICE) and tiles.dtype == np.int8
    assert w.tiles.is_contiguous()
    back = np.zeros((n, slices * MLP_SLICE), np.int8)
    for row in range(n):
        for c in range(MLP_SLICE // VEC):
            p = c ^ (row & 7)
            back[row].reshape(slices, -1, VEC)[:, c] = \
                tiles[:, row].reshape(slices, -1, VEC)[:, p]
    np.testing.assert_array_equal(back[:, :k32], w.nk32.numpy())
    assert not back[:, k32:].any(), "the K padding must be zero levels"
    for row0 in range(0, 16, 8):
        for c in range(MLP_SLICE // VEC):
            groups = {((row0 + r) * MLP_SLICE
                       + ((c ^ ((row0 + r) & 7)) << 4)) % 128 // VEC
                      for r in range(8)}
            assert len(groups) == 8


class MlpEmu:
    """The launcher's layout (`bnn_fused_mlp`) and one block of `mlp_kernel`
    at a time: the producer warp's bulk copies land when they are asked
    for (the earliest the hardware could deliver them), so a tile copied
    over one still in use shows."""

    def __init__(self, x, weights, thresholds, scale, bias, abits,
                 out_codes=False):
        """out_codes: the last layer is thresholded too (thresholds has an
        entry for it) and its int8 codes are the output."""
        self.out_codes = out_codes
        self.x = x.reshape(-1)
        self.m, self.k0 = x.shape
        self.vec_rows = self.k0 % VEC == 0
        self.nthr = thresholds[0].shape[0] if thresholds else 1
        self.off = 1 if abits == 1 else 3
        self.scale, self.bias = scale, bias
        self.layers = []
        self.thr_total = self.total_slices = 0
        width = [0, 0]
        pass_cols = 0
        k_in = self.k0
        for l, w in enumerate(weights):
            k32, n = w.nk32.shape[1], w.kn.shape[1]
            assert k32 == round_up(k_in, MMA_K)
            assert tuple(w.tiles.shape) == (-(-k32 // MLP_SLICE), n,
                                            MLP_SLICE)
            L = dict(tiles=w.tiles.numpy().reshape(-1), wsum=w.wsum.numpy(),
                     k32=k32, n=n, cw=32 if n > WARPS * 16 else 16)
            if l + 1 < len(weights) or out_codes:
                L["thr"] = thresholds[l].numpy()
                L["thr_off"] = self.thr_total
                L["thr_pad"] = round_up(n, ITEM_COLS) + ITEM_COLS
                self.thr_total += self.nthr * L["thr_pad"]
            self.total_slices += self.n_passes(L) * self.n_slices(L)
            width[l & 1] = max(width[l & 1], k32)
            pass_cols = max(pass_cols, WARPS * L["cw"])
            self.layers.append(L)
            k_in = n
        self.pitch = [padded_pitch(width[0]), padded_pitch(width[1])]
        self.stage_bytes = pass_cols * MLP_SLICE
        # the kernel's carving of shared memory
        self.ring = 0
        self.act = [MLP_STAGES * self.stage_bytes]
        self.act.append(self.act[0] + MLP_ROWS * self.pitch[0])
        self.thr_s = self.act[1] + MLP_ROWS * self.pitch[1]
        self.stages = self.thr_s + 4 * self.thr_total
        self.smem_bytes = self.stages + WARPS * STAGE_BYTES \
            + 8 * (MLP_STAGES + 1)
        n_last = self.layers[-1]["n"]
        self.out_vec = n_last % VEC == 0
        self.out = np.full((self.m, n_last), -1, np.int8) if out_codes \
            else np.full((self.m, n_last), np.nan, np.float32)

    @staticmethod
    def n_slices(L):
        return -(-L["k32"] // MLP_SLICE)

    @staticmethod
    def n_passes(L):
        return -(-L["n"] // (WARPS * L["cw"]))

    def produce(self, smem, c, slot):
        """Lane 0 of the producer warp: one bulk copy, then its cursor."""
        L = self.layers[c["l"]]
        pass_cols = WARPS * L["cw"]
        nc0 = c["pass"] * pass_cols
        nbytes = min(pass_cols, L["n"] - nc0) * MLP_SLICE
        assert nbytes % 16 == 0 and nbytes <= self.stage_bytes
        dst = self.ring + slot * self.stage_bytes
        src = (c["s"] * L["n"] + nc0) * MLP_SLICE
        smem[dst:dst + nbytes] = L["tiles"][src:src + nbytes]
        c["s"] += 1
        if c["s"] == self.n_slices(L):
            c["s"] = 0
            c["pass"] += 1
            if c["pass"] == self.n_passes(L):
                c["pass"] = 0
                c["l"] += 1

    def item_store_logits(self, acc, L, row0, rows, col0, cols):
        g, t = LANES >> 2, LANES & 3
        for j in range(8):
            for c in range(2):
                for lane in range(32):
                    n = 8 * j + 2 * t[lane] + c
                    if n >= cols:
                        continue
                    col = col0 + n
                    sub = self.off * int(L["wsum"][col])
                    for mb in range(2):
                        for h in range(2):
                            rr = 16 * mb + 8 * h + g[lane]
                            if rr < rows:
                                v = np.float32(
                                    2 * int(acc[mb, j, lane, 2 * h + c])
                                    - sub)
                                self.out[row0 + rr, col] = \
                                    np.float32(v * self.scale[col]) \
                                    + self.bias[col]

    def block(self, block_idx, rng):
        smem = rng.integers(-128, 128, size=self.smem_bytes).astype(np.int8)
        thr_s = np.full(self.thr_total, 12345, np.int64)     # garbage
        row0 = block_idx * MLP_ROWS
        for r in range(MLP_ROWS):        # a bulk copy, or bytes, a row
            row = min(row0 + r, self.m - 1)
            d = self.act[0] + r * self.pitch[0]
            smem[d:d + self.k0] = self.x[row * self.k0:(row + 1) * self.k0]
        prod = {"l": 0, "pass": 0, "s": 0}
        for it in range(min(MLP_STAGES - 1, self.total_slices)):
            self.produce(smem, prod, it)
        for L in self.layers if self.out_codes else self.layers[:-1]:
            ep = (L["thr"], L["wsum"], L["n"], self.off, True)
            o = L["thr_off"]
            thr_s[o:o + self.nthr * L["thr_pad"]] = stage_thresholds(
                L["thr_pad"], ep, 0, L["n"])
        it = slot = 0
        for l, L in enumerate(self.layers):
            k32, n_out, cw = L["k32"], L["n"], L["cw"]
            pass_cols = WARPS * cw
            pitch = self.pitch[l & 1]
            a0 = self.act[l & 1] + a_lane_row(LANES) * pitch + a_lane_k(LANES)
            a1 = a0 + 16 * pitch
            for pas in range(self.n_passes(L)):
                nc0 = pas * pass_cols
                ncols = min(pass_cols, n_out - nc0)
                accs = np.zeros((WARPS, 2, 8, 32, 4), np.int64)
                for s in range(self.n_slices(L)):
                    # ring_sync: the producer asks for the tile two ahead
                    if it + MLP_STAGES - 1 < self.total_slices:
                        self.produce(smem, prod,
                                     (it + MLP_STAGES - 1) % MLP_STAGES)
                    tile = self.ring + slot * self.stage_bytes
                    for warp in range(WARPS):
                        n0 = warp * cw
                        if n0 >= ncols:
                            continue
                        brow, bx = [], []
                        for jp in range(2):
                            r = np.maximum(np.minimum(
                                n0 + 16 * jp + b_lane_col(LANES), ncols - 1),
                                0)
                            brow.append(tile + r * MLP_SLICE)
                            bx.append((r & 7) ^ (b_lane_k(LANES) >> 4))
                        steps = min(MLP_SLICE, k32 - s * MLP_SLICE) // MMA_K
                        tile_mma(2 if cw == 32 else 1, accs[warp], smem,
                                 a0 + s * MLP_SLICE, a1 + s * MLP_SLICE,
                                 brow, bx, steps)
                    it += 1
                    slot = (slot + 1) % MLP_STAGES
                for warp in range(WARPS):
                    n0 = warp * cw
                    if n0 >= ncols:
                        continue
                    cols = min(cw, ncols - n0)
                    col0 = nc0 + n0
                    rows = min(MLP_ROWS, self.m - row0)
                    if l + 1 < len(self.layers):
                        nxt = (l + 1) & 1
                        view = smem[self.act[nxt]:self.act[nxt]
                                    + MLP_ROWS * self.pitch[nxt]]
                        tile2 = view.reshape(MLP_ROWS, -1).copy()
                        item_store_codes(
                            accs[warp], thr_s[L["thr_off"] + col0:],
                            L["thr_pad"], self.nthr, tile2, 0, MLP_ROWS,
                            col0, cols, cols % VEC == 0)
                        view[:] = tile2.reshape(-1)
                    elif self.out_codes:
                        item_store_codes(
                            accs[warp], thr_s[L["thr_off"] + col0:],
                            L["thr_pad"], self.nthr, self.out, row0, rows,
                            col0, cols, cols % VEC == 0 and self.out_vec)
                    else:
                        self.item_store_logits(accs[warp], L, row0, rows,
                                               col0, cols)

    def run(self):
        rng = np.random.default_rng(97)
        for blk in range(-(-self.m // MLP_ROWS)):
            self.block(blk, rng)
        return self.out


def _mlp_case(rng, widths, wbits, abits, m):
    ws, ts = _layers(rng, widths, wbits, abits)
    x = rng.integers(0, 2 ** abits, size=(m, widths[0])).astype(np.int8)
    scale = rng.uniform(0.01, 1.0, size=widths[-1]).astype(np.float32)
    bias = rng.standard_normal(widths[-1]).astype(np.float32)
    return x, ws, ts[:-1], scale, bias


MLP_CASES = {
    # name: (wbits, abits, m, widths)
    "w1a1 ragged rows, N=10 last": (1, 1, 37, [96, 64, 10]),
    "w2a2 three thresholds, N=100 hidden": (2, 2, 33, [64, 100, 48, 10]),
    "w1a1 K0=40 byte rows, one row": (1, 1, 1, [40, 72, 10]),
    "w1a1 K0=784 (pads to 800), 256 wide": (1, 1, 7, [784, 256, 10]),
    "w2a2 two column passes (N=264), K=160": (2, 2, 20, [160, 264, 136, 5]),
    "w1a1 single layer (no thresholds)": (1, 1, 35, [96, 10]),
    "w1a2 four layers, odd widths": (1, 2, 40, [72, 130, 24, 300, 12]),
}


@pytest.mark.parametrize("case", list(MLP_CASES))
def test_mlp_kernel_arithmetic_equals_plain(case):
    wbits, abits, m, widths = MLP_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    x, ws, ts, scale, bias = _mlp_case(rng, widths, wbits, abits, m)
    pw, pt = _port(ws, ts)
    want = fused_mlp.fused_mlp_forward_plain(
        torch.from_numpy(x), pw, pt, torch.from_numpy(scale),
        torch.from_numpy(bias), abits=abits)
    emu = MlpEmu(x, pw, pt, scale, bias, abits)
    got = emu.run()
    assert emu.smem_bytes <= MAX_SMEM
    assert np.isfinite(got).all(), "a logit was never stored"
    np.testing.assert_array_equal(got, want.numpy())


def test_mlp_folded_thresholds_keep_the_sentinels():
    rng = np.random.default_rng(6)
    x, ws, ts, scale, bias = _mlp_case(rng, [64, 48, 10], 2, 2, 40)
    ts[0][0, ::3] = -2 ** 31
    ts[0][2, ::2] = 2 ** 31 - 1
    ts[0][:, 5] = 2 ** 31 - 1
    ts[0][:, 7] = -2 ** 31
    pw, pt = _port(ws, ts)
    want = fused_mlp.fused_mlp_forward_plain(
        torch.from_numpy(x), pw, pt, torch.from_numpy(scale),
        torch.from_numpy(bias), abits=2)
    got = MlpEmu(x, pw, pt, scale, bias, 2).run()
    np.testing.assert_array_equal(got, want.numpy())


def test_mlp_shapes_fit_shared_memory():
    """The launcher's layout at the three MLPs of the main paths (CNV's
    tail, LFC, SFC), with one and with three thresholds: both activation
    tiles, every layer's folded thresholds, the warps' staging buffers and
    three ring stages fit a block's shared memory; rows are pitched ≡ 16
    (mod 32) bytes; a ring stage holds the widest pass (8 warps × 32
    columns of 128 bytes) and starts at a multiple of 128 bytes."""
    for widths, slices in (([2304, 256, 512, 512, 10], 18 + 2 * 2 + 2 * 4 + 4),
                           ([784, 1024, 1024, 1024, 10],
                            4 * 7 + 4 * 8 + 4 * 8 + 8),
                           ([784, 256, 256, 256, 10], 7 + 2 + 2 + 2)):
        for nthr in (1, 3):
            ws = [weight_matrix(torch.zeros((k, n), dtype=torch.int8))
                  for k, n in zip(widths[:-1], widths[1:])]
            ts = [torch.zeros((nthr, n), dtype=torch.int32)
                  for n in widths[1:-1]]
            emu = MlpEmu(np.zeros((1024, widths[0]), np.int8), ws, ts,
                         np.ones(10, np.float32), np.zeros(10, np.float32),
                         1 if nthr == 1 else 2)
            assert emu.total_slices == slices, widths
            assert emu.smem_bytes <= MAX_SMEM, (widths, nthr)
            assert all(p % 32 == 16 for p in emu.pitch)
            assert emu.stage_bytes == 256 * MLP_SLICE
            assert emu.thr_s % 16 == 0 and emu.stages % 16 == 0
            assert (emu.smem_bytes - 8 * (MLP_STAGES + 1)) % 8 == 0
            assert emu.pitch[0] >= widths[0] and emu.pitch[1] >= widths[1]


# -- the wrappers on CPU tensors against the JAX kernels ------------------------

@pytest.mark.parametrize("case", ["int32 out", "stride 2", "N=10",
                                  "W2A2 int32 out"])
def test_conv2d_direct_matches_jax(case):
    wbits = abits = 2 if case.startswith("W2A2") else 1
    rng = np.random.default_rng(sum(map(ord, case)))
    cout = 10 if case == "N=10" else 32
    stride = 2 if case == "stride 2" else 1
    ws, ts = _layers(rng, [32, cout], wbits, abits, k=3)
    x = rng.integers(0, 2 ** abits, size=(4, 9, 9, 32)).astype(np.int8)
    thr = None if "int32" in case else ts[0]
    want = jax_conv2d_direct(
        jnp.asarray(x), jnp.asarray(ws[0]),
        None if thr is None else jnp.asarray(thr), kernel=3, abits=abits,
        stride=stride, interpret=True)
    pw, pt = _port(ws, ts)
    got = conv_direct.conv2d_direct(torch.from_numpy(x), pw[0],
                                    None if thr is None else pt[0],
                                    kernel=3, abits=abits, stride=stride)
    assert got.dtype == (torch.int32 if thr is None else torch.int8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,widths", [(1, [784, 64, 10]),
                                      (5, [784, 256, 64, 10]),
                                      (3, [96, 10])])
def test_fused_mlp_matches_jax(m, widths):
    rng = np.random.default_rng(m + len(widths))
    x, ws, ts, scale, bias = _mlp_case(rng, widths, 1, 1, m)
    want = jax_fused_mlp(jnp.asarray(x), _jax(ws), _jax(ts),
                         jnp.asarray(scale), jnp.asarray(bias), abits=1,
                         interpret=True)
    pw, pt = _port(ws, ts)
    got = fused_mlp.fused_mlp_forward(
        torch.from_numpy(x), pw, pt, torch.from_numpy(scale),
        torch.from_numpy(bias), abits=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
