"""The tensor-core kernels' host-side layout and index arithmetic, on the CPU.

`csrc/conv_tile.cuh` (the conv kernel of `conv_chain.cu` and of
`conv_direct.cu::bnn_conv_direct`) and `csrc/dense_block.cu` run only on a
card (`tests/test_torch_mma_layout2.py` holds `bnn_conv_direct`'s own
paths and `csrc/dense_chain.cu`). What can
go wrong in them without the compiler noticing is arithmetic: which input
rows a tile stages, where a pixel's tap lies in the staged tile, which
thread holds which bytes of an `m16n8k32` fragment, which accumulator
belongs to which output. This file transliterates that arithmetic into
numpy, statement by statement (tile → staged rows → tap offsets → ldmatrix
lanes → mma fragments → accumulator coordinates → epilogue), with the
fragment layouts of the PTX manual, and holds the result against the plain
versions. Shared memory starts as garbage, so a byte the kernels must never
depend on shows up as a wrong code.

(a) the weight layout the kernels read; (b) the transliteration against
`conv_chain_plain` / `dense_block_plain`; (c) the wrappers on CPU tensors
against the JAX kernels. Integer codes throughout: every comparison exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bnn_pynq_tpu.ops.conv_stack import conv_chain_vmem
from bnn_pynq_tpu.ops.conv_stack import dense_block as jax_dense_block
from bnn_pynq_tpu_torch.models.params import (K_ALIGN_MMA, WeightMatrix,
                                              weight_matrix)
from bnn_pynq_tpu_torch.ops import conv_stack

# csrc/common.cuh, csrc/mma_tile.cuh, csrc/dense_block.cu
THREADS, VEC, MAX_SMEM = 256, 16, 227 * 1024
SMEM_PER_SM, RESERVED_SMEM = 228 * 1024, 1024
MMA_K, ITEM_ROWS, ITEM_COLS, PITCH_PAD = 32, 32, 64, 16
WARPS = THREADS // 32
SLICE, STAGES = 64, 3
SLICE_PITCH = SLICE + PITCH_PAD
MAX_COLS = 4 * ITEM_COLS
LANES = np.arange(32)


def round_up(x, m):
    return (x + m - 1) // m * m


def padded_pitch(nbytes):
    return round_up(nbytes, MMA_K) + PITCH_PAD


# -- mma_tile.cuh -----------------------------------------------------------

def a_lane_row(lane):
    return (lane & 7) + ((lane >> 3) & 1) * 8


def a_lane_k(lane):
    return (lane >> 4) * 16


def b_lane_col(lane):
    return (lane & 7) + (lane >> 4) * 8


def b_lane_k(lane):
    return ((lane >> 3) & 1) * 16


def ldmatrix_x4(smem, addr):
    """addr: [32] byte addresses, one per lane. Lane l of matrix q = l // 8
    names row l % 8 (16 bytes); every lane receives, for each of the four
    matrices, bytes 4t..4t+3 of row g. Returns int8 [32, 4, 4]."""
    assert (addr % 16 == 0).all(), "ldmatrix rows are 16-byte aligned"
    g, t = LANES >> 2, LANES & 3
    out = np.empty((32, 4, 4), np.int8)
    for q in range(4):
        rows = addr[8 * q + g]                       # row g of matrix q
        out[:, q, :] = smem[rows[:, None] + 4 * t[:, None] + np.arange(4)]
    return out


def mma_s8(c, a, b0, b1):
    """m16n8k32: c [32, 4] int32 += A·B with the fragments of the PTX
    manual. a [32, 4, 4] int8 (registers a0..a3), b0/b1 [32, 4] int8."""
    g, t = LANES >> 2, LANES & 3
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for i in range(4):
        A[g, 4 * t + i] = a[:, 0, i]
        A[g + 8, 4 * t + i] = a[:, 1, i]
        A[g, 16 + 4 * t + i] = a[:, 2, i]
        A[g + 8, 16 + 4 * t + i] = a[:, 3, i]
        B[4 * t + i, g] = b0[:, i]
        B[16 + 4 * t + i, g] = b1[:, i]
    D = A @ B
    c[:, 0] += D[g, 2 * t]
    c[:, 1] += D[g, 2 * t + 1]
    c[:, 2] += D[g + 8, 2 * t]
    c[:, 3] += D[g + 8, 2 * t + 1]


def item_mma(acc, smem, a_addr, b_addr, steps, ncols):
    """acc [2, 8, 32, 4]; a_addr [2][32], b_addr [4][32]."""
    for s in range(steps):
        off = s * MMA_K
        a = [ldmatrix_x4(smem, a_addr[mb] + off) for mb in range(2)]
        for jp in range(4):
            # a full item runs all four pairs unconditionally
            if ncols == ITEM_COLS or jp * 16 < ncols:
                b = ldmatrix_x4(smem, b_addr[jp] + off)
                for mb in range(2):
                    mma_s8(acc[mb, 2 * jp], a[mb], b[:, 0], b[:, 1])
                    mma_s8(acc[mb, 2 * jp + 1], a[mb], b[:, 2], b[:, 3])


STAGE_PITCH = ITEM_COLS + PITCH_PAD
THR_NEVER = 0x7fffffff
MAX_THR, SEARCH_SKEW = 15, 2


def thr_pitch(nthr, cols_pad):
    """Words between two thresholds of a staged column."""
    return cols_pad + SEARCH_SKEW if nthr == MAX_THR else cols_pad


def thr_words(nthr, cols_pad):
    """Staged words of a table, rounded up to 16 bytes."""
    return round_up(nthr * thr_pitch(nthr, cols_pad), 4)


def search_slot(n):
    """Where a searched table stages column n: 2t + c → 4c + t of its 8."""
    return (n & ~7) | ((n & 1) << 2) | ((n >> 1) & 3)


def stage_thresholds(cols_pad, ep, nc0, ncols):
    """thr_s: the thresholds folded onto the raw accumulator (codes in:
    acc ≥ ceil((thr + off·wsum) / 2)), clamped; [nthr · cols_pad], or for
    15 [15 · thr_pitch] with column n in search_slot(n) and the skew words
    left as garbage."""
    thr, wsum, n_out, off, codes_in = ep
    nthr = thr.shape[0]
    pitch = thr_pitch(nthr, cols_pad)
    thr_s = np.random.default_rng(nc0).integers(
        -2 ** 31, 2 ** 31, size=nthr * pitch)
    for i in range(nthr * cols_pad):
        k, n = divmod(i, cols_pad)
        x = THR_NEVER
        if n < ncols:
            x = int(thr[k, nc0 + n])
            if codes_in:
                x = (x + off * int(wsum[nc0 + n]) + 1) >> 1
            x = min(max(x, -THR_NEVER - 1), THR_NEVER)
        thr_s[k * pitch + search_slot(n) if nthr == MAX_THR else i] = x
    return thr_s


def block_codes(acc, mb, j, thr_s, cols_pad, nthr, shift=0):
    """code [h][c][lane]: 1-3 thresholds compared one by one, 15 searched
    (each column ascending): pos += acc >= t[pos + s - 1] ? s : 0. shift:
    each lane's thresholds that many columns on (the pooled epilogue's
    8·u), 0 or an array over the lanes."""
    t = LANES & 3
    code = np.zeros((2, 2, 32), np.int64)
    if nthr != MAX_THR:
        for k in range(nthr):
            th = [thr_s[k * cols_pad + shift + 8 * j + 2 * t + c]
                  for c in (0, 1)]
            for h in range(2):
                for c in range(2):
                    code[h, c] += acc[mb, j, :, 2 * h + c] >= th[c]
        return code
    pitch = thr_pitch(nthr, cols_pad)
    for c in range(2):
        col = shift + 8 * j + 4 * c + t              # the lane's slot
        mid = thr_s[col + 7 * pitch]
        for h in range(2):
            a = acc[mb, j, :, 2 * h + c]
            pos = np.where(a >= mid, 8, 0)
            pos += np.where(a >= thr_s[col + (pos + 3) * pitch], 4, 0)
            pos += np.where(a >= thr_s[col + (pos + 1) * pitch], 2, 0)
            pos += np.where(a >= thr_s[col + pos * pitch], 1, 0)
            code[h, c] = pos
    return code


def item_store_codes(acc, thr_s, cols_pad, nthr, out, row0, rows, col0, cols,
                     vec):
    """out: [all rows, n_out] int8. thr_s starts at the item's column 0."""
    g, t = LANES >> 2, LANES & 3
    for mb in range(2):
        stage = np.full(16 * STAGE_PITCH, 0x55, np.int8)
        for j in range(8):
            code = block_codes(acc, mb, j, thr_s, cols_pad, nthr)
            for h in range(2):
                for lane in range(32):
                    if vec:
                        d = (8 * h + g[lane]) * STAGE_PITCH + 8 * j + 2 * t[lane]
                        stage[d], stage[d + 1] = code[h, 0, lane], \
                            code[h, 1, lane]
                    else:
                        r = 16 * mb + 8 * h + g[lane]
                        n = 8 * j + 2 * t[lane]
                        if r < rows:
                            if n < cols:
                                out[row0 + r, col0 + n] = code[h, 0, lane]
                            if n + 1 < cols:
                                out[row0 + r, col0 + n + 1] = code[h, 1, lane]
        if vec:
            for i in range(2):
                for lane in range(32):
                    q = lane + 32 * i
                    r, c16 = q >> 2, (q & 3) * VEC
                    if 16 * mb + r < rows and c16 < cols:
                        out[row0 + 16 * mb + r, col0 + c16:col0 + c16 + VEC] \
                            = stage[r * STAGE_PITCH + c16:
                                    r * STAGE_PITCH + c16 + VEC]


def pool_windows(acc, mb):
    """The two exchanges of m16 block mb, in place: with the lanes 4 apart
    (bit 0 of u = g % 4: the odd n8 blocks kept), into blocks 0, 2, 4, 6;
    then 8 apart (bit 1: blocks 2 and 3 of each 4 kept), into blocks 0 and
    4, which then hold the window maxima of blocks u and 4 + u."""
    odd, high = (LANES & 4) != 0, (LANES & 8) != 0
    for jp in range(4):
        for e in range(4):
            lo, hi = acc[mb, 2 * jp, :, e].copy(), acc[mb, 2 * jp + 1, :, e]
            other = np.where(odd, lo, hi)[LANES ^ 4]  # __shfl_xor_sync 4
            acc[mb, 2 * jp, :, e] = np.maximum(np.where(odd, hi, lo), other)
    for k in range(2):
        for e in range(4):
            lo, hi = acc[mb, 4 * k, :, e].copy(), acc[mb, 4 * k + 2, :, e]
            other = np.where(high, lo, hi)[LANES ^ 8]
            acc[mb, 4 * k, :, e] = np.maximum(np.where(high, hi, lo), other)


def pooled_stores(mb, k, h):
    """(window, column) of item_store_pooled_n's store of code[h][c] in
    each lane, c = 0 (column + 1 for c = 1): window 4·mb + 2·h + lane / 16,
    column 8·(4k + u) + 2t."""
    u, t = (LANES >> 2) & 3, LANES & 3
    return 4 * mb + 2 * h + (LANES >> 4), 8 * (4 * k + u) + 2 * t


def item_store_pooled(acc, thr_s, cols_pad, nthr, out, win0, windows, col0,
                      cols, pairs):
    """out: [all windows, n_out] int8. thr_s starts at the item's column
    0. Each window's largest accumulator, thresholded; overwrites acc."""
    u = (LANES >> 2) & 3
    for mb in range(2):
        pool_windows(acc, mb)
        for k in range(2):
            code = block_codes(acc, mb, 4 * k, thr_s, cols_pad, nthr,
                               shift=8 * u)
            for h in range(2):
                w, n = pooled_stores(mb, k, h)
                for lane in range(32):
                    if w[lane] >= windows or n[lane] >= cols:
                        continue
                    o = (win0 + w[lane], col0 + n[lane])
                    if pairs and n[lane] + 1 < cols:
                        out[o[0], o[1]:o[1] + 2] = code[h, :, lane]
                    else:
                        out[o] = code[h, 0, lane]
                        if n[lane] + 1 < cols:
                            out[o[0], o[1] + 1] = code[h, 1, lane]


def stage_acc_correction(cols_pad, ep, nc0, ncols):
    """sub_s [cols_pad]: off·wsum where the dot ran on codes, else 0."""
    _, wsum, _, off, codes_in = ep
    return np.array([off * int(wsum[nc0 + n]) if n < ncols and codes_in
                     else 0 for n in range(cols_pad)], np.int64)


def item_store_acc(acc, sub_s, mul, out, row0, rows, col0, cols, pairs):
    """out: [all rows, n_out] int32. sub_s starts at the item's column 0."""
    g, t = LANES >> 2, LANES & 3
    for mb in range(2):
        for j in range(8):
            for lane in range(32):
                n = 8 * j + 2 * t[lane]
                sub = sub_s[n], sub_s[n + 1]          # one 8-byte load
                for h in range(2):
                    rr = 16 * mb + 8 * h + g[lane]
                    if rr >= rows or n >= cols:
                        continue
                    v = [mul * acc[mb, j, lane, 2 * h + c] - sub[c]
                         for c in range(2)]
                    if pairs and n + 1 < cols:
                        out[row0 + rr, col0 + n:col0 + n + 2] = v
                    else:
                        out[row0 + rr, col0 + n] = v[0]
                        if n + 1 < cols:
                            out[row0 + rr, col0 + n + 1] = v[1]


# -- conv_tile.cuh ------------------------------------------------------------

class ConvEmu:
    """`thr` None: the int32 epilogue (kConvAcc); pool: the 2×2 max-pool
    of the codes (kConvPool), the tile's pixels window by window. grid:
    blocks along x; room: the blocks the card holds at once (SMs ×
    resident), which decides whether the column chunks go on the grid's
    second axis."""

    def __init__(self, x, ksize, input_levels, w: WeightMatrix, thr, abits,
                 tile=None, grid=3, room=6, pool=False):
        self.x = x.reshape(-1)
        b, self.h, self.w, self.c = x.shape
        self.ksize, self.input_levels = ksize, input_levels
        self.wt = w.nk32.numpy().reshape(-1)
        self.k32 = w.nk32.shape[1]
        assert self.k32 == round_up(ksize * ksize * self.c, MMA_K)
        self.n_out = w.kn.shape[1]
        self.oh, self.ow = self.h - ksize + 1, self.w - ksize + 1
        self.pixels = b * self.oh * self.ow
        self.pool = pool
        assert not pool or (self.oh % 2 == 0 and self.ow % 2 == 0), \
            "the launcher refuses an odd map"
        assert not (pool and thr is None)
        self.halo = halo = self.c % MMA_K == 0
        self.a_pitch = padded_pitch(self.c if halo else self.k32)
        self.w_pitch = padded_pitch(self.k32)
        if abits == 4:                 # unsigned 4-bit codes are levels
            self.input_levels = input_levels = True
        self.off = 1 if abits == 1 else 3
        self.acc_out = thr is None
        self.ep = (None if thr is None else thr.numpy(), w.wsum.numpy(),
                   self.n_out, self.off, halo and not input_levels)
        # the launcher's sizing
        self.warps = WARPS
        self.tile = tile or (256 if self.n_out <= ITEM_COLS else 128)
        self.n_chunk = round_up(self.n_out, 8)
        while self.n_chunk > 8 and \
                self.n_chunk * self.w_pitch > MAX_SMEM // 3 * 2:
            self.n_chunk = round_up(self.n_chunk // 2, 8)
        nthr = self.thr_rows = 1 if thr is None else thr.shape[0]

        def smem_of(tile, warps):
            self.tile = tile
            span = self.max_tile_rows() * self.w
            self.rows_bytes = span * self.a_pitch if halo else 0
            self.patch_bytes = 0 if halo else tile * self.a_pitch
            return self.n_chunk * self.w_pitch + \
                thr_words(nthr, round_up(self.n_chunk, ITEM_COLS)) * 4 + \
                (0 if pool else warps * 16 * STAGE_PITCH) + \
                self.patch_bytes + 2 * self.rows_bytes + tile * 4

        while smem_of(self.tile, self.warps) > MAX_SMEM:
            if self.tile > ITEM_ROWS:
                self.tile //= 2
            else:
                assert self.n_chunk > 8
                self.n_chunk = round_up(self.n_chunk // 2, 8)
        tile8 = self.tile
        if 2 * (smem_of(tile8, WARPS) + RESERVED_SMEM) > SMEM_PER_SM and \
                smem_of(2 * tile8, 2 * WARPS) <= MAX_SMEM:
            self.warps, tile8 = 2 * WARPS, 2 * tile8
        smem = smem_of(tile8, self.warps)
        self.smem_bytes = smem
        self.grid = grid
        ntiles = -(-self.pixels // self.tile)
        chunks = -(-self.n_out // self.n_chunk)
        self.grid_y = chunks if ntiles * chunks <= room else 1
        self.out = np.full((self.pixels // (4 if pool else 1), self.n_out),
                           -1, np.int32 if self.acc_out else np.int8)

    def max_tile_rows(self):
        f = 2 if self.pool else 1
        cells = self.tile // (f * f)
        out_rows = (cells - 1) // (self.ow // f) + 2
        images = (cells - 1) // ((self.oh // f) * (self.ow // f)) + 2
        return f * out_rows + images * (self.ksize - 1)

    def input_row_of(self, p):
        """p: an int or an array of tile pixels."""
        if self.pool:
            ph = self.oh >> 1
            q = (p >> 2) // (self.ow >> 1)
            return (q // ph) * self.h + 2 * (q % ph) + ((p >> 1) & 1)
        q = p // self.ow
        return (q // self.oh) * self.h + q % self.oh

    def column_of(self, p):
        if self.pool:
            return 2 * ((p >> 2) % (self.ow >> 1)) + (p & 1)
        return p % self.ow

    def copy_rows(self, smem, p0, p1, buf):
        first = self.input_row_of(p0)
        count = self.input_row_of(p1) + self.ksize - first
        assert count * self.w * self.a_pitch <= self.rows_bytes, \
            "a tile's rows overflow the buffer the launcher sized"
        cv = self.c // VEC
        src = first * self.w * self.c
        for i in range(count * self.w * cv):
            pix, v = divmod(i, cv)
            d = buf + pix * self.a_pitch + v * VEC
            smem[d:d + VEC] = self.x[src + i * VEC:src + (i + 1) * VEC]

    def gather_patches(self, smem, p0, p1, buf):
        run = self.ksize * self.c
        threads = 32 * self.warps
        parts = threads // self.tile
        for tid in range(threads):
            r = tid % self.tile
            if p0 + r > p1:
                continue
            p = p0 + r
            row0 = self.input_row_of(p)
            for ki in range(tid // self.tile, self.ksize, parts):
                src = ((row0 + ki) * self.w + self.column_of(p)) * self.c
                v = self.x[src:src + run].astype(np.int64)
                if not self.input_levels:
                    v = 2 * v - self.off
                d = buf + r * self.a_pitch + ki * run
                smem[d:d + run] = v

    def block(self, block_idx, block_y, rng):
        smem = rng.integers(-128, 128, size=self.smem_bytes).astype(np.int8)
        wsm = 0
        patches = self.smem_bytes - self.tile * 4 - 2 * self.rows_bytes - \
            self.patch_bytes
        rows0 = patches + self.patch_bytes
        rows1 = rows0 + self.rows_bytes
        halo = self.halo
        ntiles = -(-self.pixels // self.tile)
        kvec = self.k32 // VEC
        ks = self.ksize if halo else 1
        c_eff = self.c if halo else self.k32
        cols_pad = round_up(self.n_chunk, ITEM_COLS)
        nthr = self.thr_rows
        out_vec = self.n_out % (2 if self.acc_out or self.pool else VEC) == 0
        for nc0 in range(block_y * self.n_chunk, self.n_out,
                         self.grid_y * self.n_chunk):
            ncols = min(self.n_chunk, self.n_out - nc0)
            if self.acc_out:
                thr_s = stage_acc_correction(cols_pad, self.ep, nc0, ncols)
            else:
                thr_s = stage_thresholds(cols_pad, self.ep, nc0, ncols)
            for i in range(ncols * kvec):
                n, v = divmod(i, kvec)
                d = wsm + n * self.w_pitch + v * VEC
                s = nc0 * self.k32 + i * VEC
                smem[d:d + VEC] = self.wt[s:s + VEC]
            tile, cur = block_idx, 0
            if halo and tile < ntiles:
                p0 = tile * self.tile
                self.copy_rows(smem, p0, min(p0 + self.tile, self.pixels) - 1,
                               rows0)
            while tile < ntiles:
                p0 = tile * self.tile
                p1 = min(p0 + self.tile, self.pixels) - 1
                rows_cur = rows1 if cur else rows0
                if halo:
                    nxt = tile + self.grid
                    if nxt < ntiles:
                        q0 = nxt * self.tile
                        self.copy_rows(
                            smem, q0, min(q0 + self.tile, self.pixels) - 1,
                            rows0 if cur else rows1)
                else:
                    self.gather_patches(smem, p0, p1, patches)
                first_row = self.input_row_of(p0) if halo else 0
                pix_off = np.empty(p1 - p0 + 1, np.int64)
                for m in range(p1 - p0 + 1):
                    p = p0 + m
                    pix_off[m] = ((self.input_row_of(p) - first_row) * self.w
                                  + self.column_of(p)) * self.a_pitch \
                        if halo else m * self.a_pitch
                at = rows_cur if halo else patches
                m_items = (p1 - p0 + ITEM_ROWS) // ITEM_ROWS
                n_items = -(-ncols // ITEM_COLS)
                for item in range(m_items * n_items):   # any warp's item
                    mi, ni = item % m_items, item // m_items
                    m0, n0 = mi * ITEM_ROWS, ni * ITEM_COLS
                    cols = min(ITEM_COLS, ncols - n0)
                    a_addr, b_addr = [], []
                    for mb in range(2):
                        m = np.minimum(m0 + 16 * mb + a_lane_row(LANES),
                                       p1 - p0)
                        a_addr.append(at + pix_off[m] + a_lane_k(LANES))
                    for jp in range(4):
                        n = np.minimum(n0 + 16 * jp + b_lane_col(LANES),
                                       ncols - 1)
                        b_addr.append(wsm + n * self.w_pitch
                                      + b_lane_k(LANES))
                    acc = np.zeros((2, 8, 32, 4), np.int64)
                    koff = 0
                    for ki in range(ks):
                        for kj in range(ks):
                            tap = (ki * self.w + kj) * self.a_pitch
                            item_mma(acc, smem, [a + tap for a in a_addr],
                                     [b + koff for b in b_addr],
                                     c_eff // MMA_K, cols)
                            koff += c_eff
                    col0 = nc0 + n0
                    rows = min(ITEM_ROWS, p1 - p0 + 1 - m0)
                    if self.acc_out:
                        item_store_acc(acc, thr_s[n0:],
                                       2 if self.ep[4] else 1, self.out,
                                       p0 + m0, rows, col0, cols, out_vec)
                    elif self.pool:
                        item_store_pooled(acc, thr_s[n0:], cols_pad, nthr,
                                          self.out, (p0 + m0) // 4, rows // 4,
                                          col0, cols, out_vec)
                    else:
                        item_store_codes(
                            acc, thr_s[n0:], cols_pad, nthr, self.out,
                            p0 + m0, rows, col0, cols,
                            out_vec and col0 % VEC == 0 and cols % VEC == 0)
                if halo:
                    cur ^= 1
                tile += self.grid

    def run(self):
        rng = np.random.default_rng(99)
        for by in range(self.grid_y):
            for blk in range(self.grid):
                self.block(blk, by, rng)
        return self.out


def emu_conv_chain(x, weights, thresholds, *, kernel, abits,
                   input_levels=False, tile=None, grid=3, pool=False):
    act = x.numpy()
    for j, (w, thr) in enumerate(zip(weights, thresholds)):
        b, h, wd, _ = act.shape
        f = 2 if pool and j == len(weights) - 1 else 1
        emu = ConvEmu(act, kernel, j == 0 and input_levels, w, thr, abits,
                      tile=tile, grid=grid, pool=f == 2)
        act = emu.run().reshape(b, (h - kernel + 1) // f,
                                (wd - kernel + 1) // f, -1)
    return act


# -- dense_block.cu -----------------------------------------------------------

def emu_dense_layer(x, input_levels, w: WeightMatrix, thr, abits):
    m, k0 = x.shape
    xf = x.reshape(-1)
    wt, k32 = w.nk32.numpy().reshape(-1), w.nk32.shape[1]
    assert k32 == round_up(k0, MMA_K)
    n_out = w.kn.shape[1]
    vec_rows = k0 % VEC == 0
    col_warps = 1 if n_out <= ITEM_COLS else 2 if n_out <= 2 * ITEM_COLS \
        else 4
    row_warps = WARPS // col_warps
    tile_rows, tile_cols = row_warps * ITEM_ROWS, col_warps * ITEM_COLS
    stage_bytes = (tile_rows + tile_cols) * SLICE_PITCH
    ep = (thr.numpy(), w.wsum.numpy(), n_out, 1 if abits == 1 else 3,
          not input_levels and abits != 4)
    out = np.full((m, n_out), -1, np.int8)
    rng = np.random.default_rng(98)
    nslices = -(-k32 // SLICE)
    kv = SLICE // VEC
    for bx in range(-(-m // tile_rows)):
        for by in range(-(-n_out // MAX_COLS)):
            smem = rng.integers(-128, 128, size=STAGES * stage_bytes) \
                .astype(np.int8)
            row0, nc0 = bx * tile_rows, by * MAX_COLS
            ncols = min(tile_cols, n_out - nc0)

            def load_slice(s):
                as_ = (s % STAGES) * stage_bytes
                bs = as_ + tile_rows * SLICE_PITCH
                k = s * SLICE
                if vec_rows:
                    for i in range(tile_rows * kv):
                        r, kb = i // kv, k + (i % kv) * VEC
                        row = min(row0 + r, m - 1)
                        if kb < k0:
                            d = as_ + r * SLICE_PITCH + (kb - k)
                            smem[d:d + VEC] = \
                                xf[row * k0 + kb:row * k0 + kb + VEC]
                else:
                    for i in range(tile_rows * SLICE):
                        r, kb = i // SLICE, k + i % SLICE
                        row = min(row0 + r, m - 1)
                        if kb < k0:
                            smem[as_ + r * SLICE_PITCH + (kb - k)] = \
                                xf[row * k0 + kb]
                for i in range(ncols * kv):
                    n, kb = i // kv, k + (i % kv) * VEC
                    if kb < k32:
                        d = bs + n * SLICE_PITCH + (kb - k)
                        s0 = (nc0 + n) * k32 + kb
                        smem[d:d + VEC] = wt[s0:s0 + VEC]

            thr_s = stage_thresholds(tile_cols, ep, nc0, ncols)
            accs = np.zeros((WARPS, 2, 8, 32, 4), np.int64)
            for s in range(nslices):
                load_slice(s)     # the ring only decides when, not what
                for warp in range(WARPS):
                    mi, n0 = warp % row_warps, (warp // row_warps) * ITEM_COLS
                    if n0 >= ncols:
                        continue
                    cols = min(ITEM_COLS, ncols - n0)
                    base = (s % STAGES) * stage_bytes
                    a_addr = [base + (mi * ITEM_ROWS + 16 * mb
                                      + a_lane_row(LANES)) * SLICE_PITCH
                              + a_lane_k(LANES) for mb in range(2)]
                    b_addr = []
                    for jp in range(4):
                        n = np.maximum(np.minimum(
                            n0 + 16 * jp + b_lane_col(LANES), ncols - 1), 0)
                        b_addr.append(base + (tile_rows + n) * SLICE_PITCH
                                      + b_lane_k(LANES))
                    item_mma(accs[warp], smem, a_addr, b_addr,
                             min(SLICE, k32 - s * SLICE) // MMA_K, cols)
            for warp in range(WARPS):
                mi, n0 = warp % row_warps, (warp // row_warps) * ITEM_COLS
                if n0 >= ncols:
                    continue
                cols = min(ITEM_COLS, ncols - n0)
                item_store_codes(
                    accs[warp], thr_s[n0:], tile_cols, thr.shape[0], out,
                    row0 + mi * ITEM_ROWS,
                    min(ITEM_ROWS, m - row0 - mi * ITEM_ROWS), nc0 + n0, cols,
                    n_out % VEC == 0 and cols % VEC == 0)
    return out


def emu_dense_block(x, weights, thresholds, *, abits, input_levels=False):
    act = x.numpy()
    for j, (w, thr) in enumerate(zip(weights, thresholds)):
        act = emu_dense_layer(act, j == 0 and input_levels, w, thr, abits)
    return act


# -- inputs ---------------------------------------------------------------------

def _layers(rng, widths, wbits, abits, k=1, image=False):
    """Random int8 levels [k²·C_in, C_out] and sorted int32 thresholds drawn
    within one standard deviation of the accumulator, so that most codes
    depend on the dot and not on the threshold alone."""
    wl = {1: [-1, 1], 2: [-3, -1, 1, 3], 4: list(range(-7, 8))}[wbits]
    nthr = 2 ** abits - 1
    ws, ts = [], []
    for j, (cin, cout) in enumerate(zip(widths[:-1], widths[1:])):
        ws.append(rng.choice(wl, size=(k * k * cin, cout)).astype(np.int8))
        sd_a = 74 if (image and j == 0) else \
            {1: 1, 2: 5 ** .5, 4: 77.5 ** .5}[abits]
        sd = int((k * k * cin) ** .5 * sd_a * float(np.std(wl)))
        ts.append(np.sort(rng.integers(-sd, sd + 1, size=(nthr, cout)),
                          axis=0).astype(np.int32))
    return ws, ts


def _port(ws, ts):
    return ([weight_matrix(torch.from_numpy(w)) for w in ws],
            [torch.from_numpy(t) for t in ts])


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


# -- (a) the weight layout ------------------------------------------------------

@pytest.mark.parametrize("n", [10, 64, 100, 256])
@pytest.mark.parametrize("k", [27, 576, 784, 1152])
def test_mma_weight_layout_round_trips(k, n):
    rng = np.random.default_rng(k + n)
    kn = torch.from_numpy(rng.choice([-3, -1, 1, 3], size=(k, n))
                          .astype(np.int8))
    w = weight_matrix(kn)
    k32 = round_up(k, K_ALIGN_MMA)
    assert w.nk32.dtype == torch.int8 and w.nk32.is_contiguous()
    assert tuple(w.nk32.shape) == (n, k32)
    assert torch.equal(w.nk32[:, :k].t(), kn), "nk32 does not give kn back"
    assert not w.nk32[:, k:].any(), "the K padding must be zero levels"
    assert w.wsum.dtype == torch.int32 and tuple(w.wsum.shape) == (n,)
    assert torch.equal(w.wsum, w.nk32.sum(dim=1, dtype=torch.int32))
    # the one K-contiguous layout: every kernel reads it or its K tiles
    assert tuple(w.tiles.shape) == (-(-k32 // 128), n, 128)
    assert w.nk32.data_ptr() % 16 == 0 and w.tiles.data_ptr() % 16 == 0
    assert not hasattr(w, "nk"), "the dp4a kernels' layout went with them"


# -- (b) the transliteration against the plain versions -------------------------

CONV_CASES = {
    # name: (wbits, abits, b, h, kernel, channels, input_levels, tile, grid)
    "w1a1 halo, ragged last tile": (1, 1, 3, 7, 3, [32, 24], False, 32, 3),
    "w2a2 halo, two buffers, N=72": (2, 2, 2, 8, 3, [64, 72], False, 32, 2),
    "w1a1 image C=3, chain of 2": (1, 1, 2, 9, 3, [3, 16, 8], True, None, 2),
    "w2a2 image C=3": (2, 2, 1, 8, 3, [3, 10], True, 32, 3),
    "w1a1 C=24 patches, 5x5": (1, 1, 1, 8, 5, [24, 12], False, 32, 2),
    "w1a1 tile across images": (1, 1, 5, 5, 3, [32, 8], False, 64, 1),
    "w2a2 chain of 3, default tile": (2, 2, 1, 9, 3, [32, 32, 64, 16],
                                      False, None, 2),
    "w4a4 1x1, 15 thresholds searched": (4, 4, 2, 6, 1, [32, 72], False,
                                         32, 2),
    "w4a4 image C=3, 15 thresholds": (4, 4, 1, 8, 3, [3, 32], True, 32, 3),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv_kernel_arithmetic_equals_plain(case):
    wbits, abits, b, h, k, chans, levels, tile, grid = CONV_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    ws, ts = _layers(rng, chans, wbits, abits, k=k, image=levels)
    if levels:
        x = rng.integers(-128, 128, size=(b, h, h, chans[0]))
    else:
        x = rng.integers(0, 2 ** abits, size=(b, h, h, chans[0]))
    x = torch.from_numpy(x.astype(np.int8))
    pw, pt = _port(ws, ts)
    want = conv_stack.conv_chain_plain(x, pw, pt, kernel=k, abits=abits,
                                       input_levels=levels)
    got = emu_conv_chain(x, pw, pt, kernel=k, abits=abits,
                         input_levels=levels, tile=tile, grid=grid)
    assert len(np.unique(want.numpy())) > 1, "a degenerate case"
    np.testing.assert_array_equal(got, want.numpy())


DENSE_CASES = {
    # name: (wbits, abits, m, widths, input_levels)
    "w1a1 ragged rows, N=10": (1, 1, 37, [96, 10], False),
    "w2a2 three layers, N=100": (2, 2, 70, [64, 100, 48, 24], False),
    "w1a1 K=40 byte rows, levels in": (1, 1, 33, [40, 72], True),
    "w2a2 K=160 (half slice), N=136": (2, 2, 65, [160, 136], False),
    "w1a1 N=264 (two column chunks)": (1, 1, 20, [32, 264], False),
    "w4a4 K=32, 15 thresholds searched": (4, 4, 45, [32, 64], False),
    "w4a4 two layers, N=100": (4, 4, 37, [64, 100, 48], False),
    "w4a4 N=264 (two column chunks)": (4, 4, 20, [32, 264], False),
}


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_kernel_arithmetic_equals_plain(case):
    wbits, abits, m, widths, levels = DENSE_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    ws, ts = _layers(rng, widths, wbits, abits)
    if levels:
        x = rng.choice([-3, -1, 1, 3], size=(m, widths[0]))
    else:
        x = rng.integers(0, 2 ** abits, size=(m, widths[0]))
    x = torch.from_numpy(x.astype(np.int8))
    pw, pt = _port(ws, ts)
    want = conv_stack.dense_block_plain(x, pw, pt, abits=abits,
                                        input_levels=levels)
    got = emu_dense_block(x, pw, pt, abits=abits, input_levels=levels)
    assert len(np.unique(want.numpy())) > 1, "a degenerate case"
    np.testing.assert_array_equal(got, want.numpy())


def test_folded_thresholds_keep_the_sentinels():
    """Thresholds at the ends of int32 (never / always) survive the fold
    onto the raw accumulator: 64-bit sum, clamped."""
    rng = np.random.default_rng(5)
    ws, ts = _layers(rng, [64, 48], 2, 2)
    ts[0][0, ::3] = -2 ** 31
    ts[0][2, ::2] = 2 ** 31 - 1
    ts[0][:, 5] = 2 ** 31 - 1
    ts[0][:, 7] = -2 ** 31
    x = torch.from_numpy(rng.integers(0, 4, size=(40, 64)).astype(np.int8))
    pw, pt = _port(ws, ts)
    want = conv_stack.dense_block_plain(x, pw, pt, abits=2)
    got = emu_dense_block(x, pw, pt, abits=2)
    np.testing.assert_array_equal(got, want.numpy())
    assert (want[:, 5] == 0).all() and (want[:, 7] == 3).all()


def test_searched_thresholds_keep_ties_and_sentinels():
    """15 thresholds a column, ascending, with repeats and the never /
    always ends of int32 in whole columns and in parts of them: the
    search's codes equal the plain count's."""
    rng = np.random.default_rng(6)
    ws, ts = _layers(rng, [64, 72], 4, 4)
    t = ts[0]
    t[5:9, ::4] = t[5, ::4]                      # ties inside a column
    t[:, 3] = -2 ** 31
    t[:, 6] = 2 ** 31 - 1
    t[:4, 10] = -2 ** 31
    t[11:, 10] = 2 ** 31 - 1
    x = torch.from_numpy(rng.integers(0, 16, size=(40, 64)).astype(np.int8))
    pw, pt = _port(ws, [np.sort(t, axis=0)])
    want = conv_stack.dense_block_plain(x, pw, pt, abits=4)
    acc = x.to(torch.int64) @ pw[0].kn.to(torch.int64)
    pt[0][7, 20] = int(acc[0, 20])               # an accumulator on a
    pt[0][:, 20] = pt[0][:, 20].sort().values    # threshold, exactly
    want = conv_stack.dense_block_plain(x, pw, pt, abits=4)
    got = emu_dense_block(x, pw, pt, abits=4)
    np.testing.assert_array_equal(got, want.numpy())
    assert (want[:, 3] == 15).all() and (want[:, 6] == 0).all()
    assert set(np.unique(want[:, 10].numpy())) <= set(range(4, 12))


@pytest.mark.parametrize("cols_pad", [64, 128, 256, 384])
def test_search_steps_load_without_bank_conflicts(cols_pad):
    """Each step of the search reads, in every lane, one threshold of one
    of the lane's two columns; the 8 lanes of a column group t may read 8
    different ones. With the staged pitch and slots, every (threshold, t)
    pair a step can read lies in a bank of its own: 32 lanes, one
    wavefront a load."""
    pitch = thr_pitch(MAX_THR, cols_pad)
    for s in (8, 4, 2, 1):
        ks = [k for k in range(MAX_THR) if k % (2 * s) == s - 1]
        for j in range(8):
            for c in range(2):
                banks = {(k * pitch + search_slot(8 * j + 2 * t + c)) % 32
                         for k in ks for t in range(4)}
                assert len(banks) == 4 * len(ks), (s, j, c)


def test_main_path_tiles_fit_shared_memory():
    """The launcher's sizing at CNV's four chain layers: the whole weight
    set is staged (one column chunk) with two activation buffers, and the
    bound on a tile's rows holds for every tile; the two middle layers run
    16 warps a block on a doubled tile, the image layer (two blocks an SM)
    and the last (no room for the larger tile) 8."""
    for h, c, n, tile, warps in ((32, 3, 64, 256, 8), (30, 64, 64, 512, 16),
                                 (14, 64, 128, 256, 16),
                                 (12, 128, 128, 128, 8)):
        x = np.zeros((4, h, h, c), np.int8)
        w = weight_matrix(torch.zeros((9 * c, n), dtype=torch.int8))
        emu = ConvEmu(x, 3, c == 3, w, torch.zeros((1, n), dtype=torch.int32),
                      1)
        assert emu.tile == tile and emu.n_chunk == n, (h, c, n)
        assert emu.warps == warps
        assert emu.smem_bytes <= MAX_SMEM
        assert emu.halo == (c != 3)
        if emu.halo:
            pixels = 1024 * emu.oh * emu.ow
            for p0 in range(0, 40 * emu.tile, emu.tile):
                p1 = min(p0 + emu.tile, pixels) - 1
                count = emu.input_row_of(p1) + 3 - emu.input_row_of(p0)
                assert count <= emu.max_tile_rows()


# -- (c) the wrappers on CPU tensors against the JAX kernels ----------------------

@pytest.mark.parametrize("wbits,abits", [(1, 1), (2, 2)])
def test_conv_chain_three_layers_matches_jax(wbits, abits):
    rng = np.random.default_rng(300 + 10 * wbits + abits)
    b, h, k, chans = 2, 12, 3, [32, 32, 64, 32]
    ws, ts = _layers(rng, chans, wbits, abits, k=k)
    x = rng.integers(0, 2 ** abits, size=(b, h, h, chans[0])).astype(np.int8)
    full = conv_chain_vmem(jnp.asarray(x), _jax(ws), _jax(ts), kernel=k,
                           abits=abits, interpret=True)
    want = np.asarray(full)[:, :h - 6, :h - 6, :]
    got = conv_stack.conv_chain(torch.from_numpy(x), *_port(ws, ts),
                                kernel=k, abits=abits)
    assert got.shape == (b, h - 6, h - 6, chans[-1])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("wbits,abits", [(1, 1), (2, 2)])
def test_dense_block_three_layers_matches_jax(wbits, abits):
    rng = np.random.default_rng(320 + 10 * wbits + abits)
    m, widths = 45, [128, 100, 64, 10]
    ws, ts = _layers(rng, widths, wbits, abits)
    x = rng.integers(0, 2 ** abits, size=(m, widths[0])).astype(np.int8)
    want = jax_dense_block(jnp.asarray(x), _jax(ws), _jax(ts), abits=abits,
                           interpret=True)
    got = conv_stack.dense_block(torch.from_numpy(x), *_port(ws, ts),
                                 abits=abits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_layer_times_tool_needs_a_card():
    """The timing tool measures device time only: without CUDA it raises
    and prints no number."""
    from bnn_pynq_tpu_torch.tools import layer_times
    if torch.cuda.is_available():
        pytest.skip("a card is present; the tool would measure")
    with pytest.raises(RuntimeError, match="CUDA card"):
        layer_times.main()
