"""`packed_matmul` and `conv_chain_direct` on the tensor cores: their index
arithmetic on the CPU.

Continues `tests/test_torch_mma_layout.py` and `tests/test_torch_mma_layout2.py`
(whose fragment, ldmatrix and epilogue transliterations it imports) for the
two kernels that followed onto `mma.sync`:

- `csrc/packed_matmul.cu`: the launcher's sizing (tile, column chunk, more
  and smaller blocks where the rows are few, the grid's second axis), the
  weights transposed into shared memory (words or decoded levels, zero
  behind the last word), `sliced_kernel`'s walk of a long K in slices with
  the accumulators and both popcounts kept across them, the run of a tile's words copied as it lies and its
  two buffers, the popcount arm's A fragments read by 32-bit loads from
  that run, the 1-bit `m16n8k256` `.and.popc` mma with the PTX manual's
  fragment layout, popc(a) per row from an all-ones B operand masked to the
  row's real words, popc(w) per column from the staged weights, the `.and`
  identity and its fold onto the thresholds, the decode arm's A fragments
  made from the words in registers (the integer arithmetic of `levels1`
  bit for bit) and `pad_term`, item → output coordinates;
- `csrc/conv_direct.cu::chain_kernel`: the plan (which layers gather, the
  weight chunks, the images a tile holds, the two activation buffers), the
  taps read in place from the previous layer's codes, the gather of patch
  rows from device or shared memory, the codes written into the other
  buffer at its pixel pitch, the last layer's store.

Statement by statement in numpy, shared memory starting as garbage,
thresholds within one standard deviation of the accumulator, every
comparison exact.
"""

import numpy as np
import pytest
import torch

from bnn_pynq_tpu_torch.models.params import weight_matrix
from bnn_pynq_tpu_torch.ops import conv_direct, matmul, packing
from tests.test_torch_mma_layout import (ITEM_COLS, ITEM_ROWS, LANES,
                                         MAX_SMEM, MMA_K, PITCH_PAD,
                                         STAGE_PITCH, THR_NEVER, VEC, WARPS,
                                         _layers, _port, a_lane_k,
                                         a_lane_row, b_lane_col, b_lane_k,
                                         item_mma, item_store_acc,
                                         item_store_codes, ldmatrix_x4,
                                         mma_s8, padded_pitch, round_up,
                                         stage_thresholds)

STAGE_BYTES = 16 * STAGE_PITCH
POPC, DECODE1, DECODE2 = 0, 1, 2
WORD_BYTES = {POPC: 4, DECODE1: 32, DECODE2: 16}
BITCOUNT = np.array([bin(i).count("1") for i in range(256)], np.int64)


def epilogue_smem(nthr, cols, warps=WARPS):
    return nthr * round_up(cols, ITEM_COLS) * 4 + warps * STAGE_BYTES


# -- packed_matmul.cu -------------------------------------------------------------

M32 = 0xffffffff


def levels1(x):
    """Bits 0..3 of x → four int8 levels 2b − 1, byte i = bit i: the
    kernel's 32-bit arithmetic (a product that spreads the bits, a mask, a
    product and an XOR that turn each byte into ±1)."""
    s = (((x & 0xf) * 0x00204081) & M32) & 0x01010101
    v = ((s * 0xfe) & M32) ^ M32
    return list(np.array([v], np.uint32).view(np.int8))


def levels2(x):
    """Bits 0..7 of x → four int8 levels 2c − 3, byte i = code i."""
    return [2 * ((x >> (2 * i)) & 3) - 3 for i in range(4)]


def stage_word(arm, word, smem, dst):
    """A packed word as it is staged at byte `dst`."""
    word = int(word)
    if arm == POPC:
        smem[dst:dst + 4] = np.array([word], np.uint32).view(np.int8)
    elif arm == DECODE1:
        assert dst % 16 == 0
        for q in range(8):
            smem[dst + 4 * q:dst + 4 * q + 4] = levels1(word >> (4 * q))
    else:
        assert dst % 16 == 0
        for q in range(4):
            smem[dst + 4 * q:dst + 4 * q + 4] = levels2(word >> (8 * q))


def mma_b1(c, a, b0, b1):
    """m16n8k256 .and.popc: c [32, 4] += popc(A AND B), the fragments of the
    PTX manual counted in bytes (a [32, 4, 4] registers a0..a3, b0/b1
    [32, 4], all uint8): a0 = row g, bits 32t.., a1 = row g + 8, a2 / a3 the
    same at bits 128 + 32t..; b0 = column g, bits 32t.., b1 at 128 + 32t..."""
    g, t = LANES >> 2, LANES & 3
    A = np.zeros((16, 32), np.uint8)
    B = np.zeros((32, 8), np.uint8)
    for i in range(4):
        A[g, 4 * t + i] = a[:, 0, i]
        A[g + 8, 4 * t + i] = a[:, 1, i]
        A[g, 16 + 4 * t + i] = a[:, 2, i]
        A[g + 8, 16 + 4 * t + i] = a[:, 3, i]
        B[4 * t + i, g] = b0[:, i]
        B[16 + 4 * t + i, g] = b1[:, i]
    D = BITCOUNT[A[:, :, None] & B[None, :, :]].sum(axis=1)    # [16, 8]
    c[:, 0] += D[g, 2 * t]
    c[:, 1] += D[g, 2 * t + 1]
    c[:, 2] += D[g + 8, 2 * t]
    c[:, 3] += D[g + 8, 2 * t + 1]


def lds32(smem, addr):
    """One 32-bit shared load a lane: [32] byte addresses → uint8 [32, 4]."""
    assert (addr % 4 == 0).all() and (addr + 4 <= smem.size).all()
    return smem[addr[:, None] + np.arange(4)].view(np.uint8)


def item_popc(acc, ra, smem, rows_addr, kw, b_addr, steps, ncols):
    """acc [2, 8, 32, 4], ra [2, 32, 4]; rows_addr [32]: the byte address of
    the lane's first A word (tile row m0 + g, word t)."""
    t = LANES & 3
    for s in range(steps):
        w0 = 8 * s
        a = []
        for mb in range(2):
            r = rows_addr + 4 * (16 * mb * kw + w0)
            a.append(np.stack([lds32(smem, r), lds32(smem, r + 4 * 8 * kw),
                               lds32(smem, r + 16),
                               lds32(smem, r + 4 * (8 * kw + 4))], axis=1))
        ones = [np.where((w0 + 4 * half + t < kw)[:, None], 0xff, 0)
                .astype(np.uint8).repeat(4, axis=1) for half in (0, 1)]
        for mb in range(2):
            mma_b1(ra[mb], a[mb], ones[0], ones[1])
        for jp in range(4):
            if jp * 16 < ncols:
                b = ldmatrix_x4(smem, b_addr[jp] + s * MMA_K).view(np.uint8)
                for mb in range(2):
                    mma_b1(acc[mb, 2 * jp], a[mb], b[:, 0], b[:, 1])
                    mma_b1(acc[mb, 2 * jp + 1], a[mb], b[:, 2], b[:, 3])


def lds32_word(smem, addr):
    """The same as one uint32 a lane."""
    return lds32(smem, addr).copy().view(np.uint32)[:, 0]


def item_decode(arm, acc, smem, rows_addr, kw, b_addr, steps, ncols):
    """acc [2, 8, 32, 4]; rows_addr [32]: the byte address of the first word
    of the lane's row (tile row m0 + g)."""
    t = LANES & 3
    lv = levels1 if arm == DECODE1 else levels2
    for s in range(steps):
        a = []
        for mb in range(2):
            r = rows_addr + 4 * 16 * mb * kw
            if arm == DECODE1:
                lo = lds32_word(smem, r + 4 * s) >> (4 * t)
                hi = lds32_word(smem, r + 4 * (8 * kw + s)) >> (4 * t)
                regs = [lo, hi, lo >> 16, hi >> 16]
            else:
                regs = [lds32_word(smem, r + 4 * w) >> (8 * t)
                        for w in (2 * s, 8 * kw + 2 * s, 2 * s + 1,
                                  8 * kw + 2 * s + 1)]
            a.append(np.array([[lv(int(x)) for x in reg] for reg in regs],
                              np.int8).transpose(1, 0, 2))     # [32, 4, 4]
        for jp in range(4):
            if jp * 16 < ncols:
                b = ldmatrix_x4(smem, b_addr[jp] + s * MMA_K)
                for mb in range(2):
                    mma_s8(acc[mb, 2 * jp], a[mb], b[:, 0], b[:, 1])
                    mma_s8(acc[mb, 2 * jp + 1], a[mb], b[:, 2], b[:, 3])


class PackedEmu:
    """`bnn_packed_matmul`: the launcher's sizing, then every block.

    a, w: uint32 words [m, kw], [kw, n]; thr int32 [nthr, n] or None.
    tile, n_chunk: override the launcher's choice (small cases walk several
    tiles and chunks); sms, resident: the card's SMs and the blocks each
    holds, which decide the grid and whether the chunks go on its second
    axis. slice_words: run `sliced_kernel` with this slice, as the launcher
    does of itself where K leaves no room for 8 columns beside a 32-row tile.
    """

    def __init__(self, a, w, thr, k, bits, route, tile=None, n_chunk=None,
                 sms=2, resident=2, slice_words=None):
        self.a = np.ascontiguousarray(a, np.uint32).reshape(-1)
        self.w = np.ascontiguousarray(w, np.uint32).reshape(-1)
        self.m, self.kw = a.shape
        self.n = w.shape[1]
        self.k, self.thr = k, thr
        per_word = 32 // bits
        assert self.kw == -(-k // per_word)
        self.arm = arm = POPC if route == "vpu" else \
            (DECODE1 if bits == 1 else DECODE2)
        padval = 1 if bits == 1 else 3
        self.pad_term = (self.kw * per_word - k) * padval * padval
        self.acc_out = thr is None
        self.nthr = 0 if thr is None else thr.shape[0]
        self.thr_rows = 1 if thr is None else self.nthr
        wb = WORD_BYTES[arm]
        self.out = np.full((self.m, self.n), -1,
                           np.int32 if self.acc_out else np.int8)
        self.sms = sms
        self.slice = None
        # launch_packed
        if slice_words or self.kw * wb > MAX_SMEM:
            self.launch_sliced(slice_words)
            return
        self.kb32 = round_up(self.kw * wb, MMA_K)
        self.w_pitch = self.kb32 + PITCH_PAD
        self.n_chunk = min(round_up(self.n, 8), 4 * ITEM_COLS)
        while self.n_chunk > 8 and \
                self.n_chunk * self.w_pitch > MAX_SMEM // 3 * 2:
            self.n_chunk = round_up(self.n_chunk // 2, 8)
        n_items = -(-self.n_chunk // ITEM_COLS)
        self.tile = ITEM_ROWS * max(1, WARPS // n_items)
        if n_chunk:
            self.n_chunk = n_chunk
        if tile:
            self.tile = tile
        while self.smem_of(self.tile) > MAX_SMEM:
            if self.tile > ITEM_ROWS:
                self.tile //= 2
            elif self.n_chunk > 8:
                self.n_chunk = round_up(self.n_chunk // 2, 8)
            else:
                assert not (tile or n_chunk)
                self.launch_sliced(None)
                return
        while self.blocks() < sms and not (tile or n_chunk):
            if self.n_chunk > ITEM_COLS:
                self.n_chunk = max(ITEM_COLS, round_up(self.n_chunk // 2, 8))
            elif self.tile > ITEM_ROWS:
                self.tile //= 2
            else:
                break
        self.smem_bytes = self.smem_of(self.tile)
        ntiles = -(-self.m // self.tile)
        room = sms * resident
        chunks = -(-self.n // self.n_chunk)
        self.grid_y = chunks if ntiles < room else 1
        self.grid = min(ntiles, room)

    def launch_sliced(self, slice_words):
        wb = WORD_BYTES[self.arm]
        self.n_chunk = min(round_up(self.n, 8), 4 * ITEM_COLS)
        n_items = -(-self.n_chunk // ITEM_COLS)
        self.tile = ITEM_ROWS * max(1, WARPS // n_items)
        fixed = self.n_chunk * PITCH_PAD \
            + epilogue_smem(self.thr_rows, self.n_chunk) \
            + round_up(self.n_chunk, ITEM_COLS) * 4 + MMA_K
        per_word = self.n_chunk * wb + self.tile * 4
        self.slice = slice_words or (MAX_SMEM - fixed) // per_word // 8 * 8
        assert self.slice >= 8 and self.slice % 8 == 0
        self.w_pitch = self.slice * wb + PITCH_PAD
        self.raw_bytes = self.tile * self.slice * 4 + MMA_K
        self.smem_bytes = fixed + per_word * self.slice
        assert self.smem_bytes <= MAX_SMEM
        units = -(-self.m // self.tile) * -(-self.n // self.n_chunk)
        self.grid, self.grid_y = min(units, self.sms), 1

    def sliced_block(self, bx, rng):
        """`sliced_kernel`: a unit is a tile × a chunk, K in slices."""
        smem = rng.integers(-128, 128, size=self.smem_bytes).astype(np.int8)
        arm, wb = self.arm, WORD_BYTES[self.arm]
        cols_pad = round_up(self.n_chunk, ITEM_COLS)
        wsm = 0
        ones_at = self.n_chunk * self.w_pitch + self.thr_rows * cols_pad * 4
        raw = ones_at + cols_pad * 4 + WARPS * STAGE_BYTES
        assert raw + self.raw_bytes == self.smem_bytes
        ntiles = -(-self.m // self.tile)
        chunks = -(-self.n // self.n_chunk)
        g, t = LANES >> 2, LANES & 3
        whole = (self.w, self.kw)
        for unit in range(bx, ntiles * chunks, self.grid):
            row0 = unit // chunks * self.tile
            nc0 = unit % chunks * self.n_chunk
            rows = min(self.tile, self.m - row0)
            ncols = min(self.n_chunk, self.n - nc0)
            m_items = -(-rows // ITEM_ROWS)
            n_items = -(-ncols // ITEM_COLS)
            assert m_items * n_items <= WARPS
            accs = {warp: (np.zeros((2, 8, 32, 4), np.int64),
                           np.zeros((2, 32, 4), np.int64))
                    for warp in range(m_items * n_items)}
            ones_s = smem[ones_at:ones_at + cols_pad * 4].view(np.int32)
            ones_s[:] = 0
            for c0 in range(0, self.kw, self.slice):
                kws = min(self.slice, self.kw - c0)
                # stage_weights on the slice as an operand pair of its own
                self.w, self.kw = whole[0][c0 * self.n:], kws
                self.kb32 = round_up(kws * wb, MMA_K)
                self.stage_weights(smem, wsm, nc0, ncols)
                self.w, self.kw = whole
                for idx in range(rows * kws):
                    r, j = divmod(idx, kws)
                    word = self.a[(row0 + r) * self.kw + c0 + j]
                    smem[raw + 4 * idx:raw + 4 * idx + 4] = \
                        np.array([word], np.uint32).view(np.int8)
                assert 4 * rows * kws + MMA_K <= self.raw_bytes
                if arm == POPC:
                    for n in range(ncols):
                        row = smem[wsm + n * self.w_pitch:
                                   wsm + n * self.w_pitch + self.kb32]
                        ones_s[n] += int(BITCOUNT[row.view(np.uint8)].sum())
                for warp, (acc, ra) in accs.items():
                    m0 = warp % m_items * ITEM_ROWS
                    n0 = warp // m_items * ITEM_COLS
                    cols = min(ITEM_COLS, ncols - n0)
                    b_addr = [wsm + np.minimum(n0 + 16 * jp
                                               + b_lane_col(LANES), ncols - 1)
                              * self.w_pitch + b_lane_k(LANES)
                              for jp in range(4)]
                    steps = self.kb32 // MMA_K
                    if arm == POPC:
                        item_popc(acc, ra, smem,
                                  raw + 4 * ((m0 + g) * kws + t), kws, b_addr,
                                  steps, cols)
                    else:
                        item_decode(arm, acc, smem, raw + 4 * (m0 + g) * kws,
                                    kws, b_addr, steps, cols)
            thr_s = self.stage_epilogue(smem, wsm, cols_pad, nc0, ncols,
                                        ones_s)
            for warp, (acc, ra) in accs.items():
                m0 = warp % m_items * ITEM_ROWS
                n0 = warp // m_items * ITEM_COLS
                self.item_finish(acc, ra, thr_s[n0:], cols_pad, row0 + m0,
                                 min(ITEM_ROWS, rows - m0), nc0 + n0,
                                 min(ITEM_COLS, ncols - n0))

    def item_finish(self, acc, ra, thr_s, cols_pad, out_row, item_rows, col0,
                    cols):
        if self.arm == POPC:
            for mb in range(2):
                for e in range(4):
                    acc[mb, :, :, e] = 2 * acc[mb, :, :, e] - ra[mb, :, e & 2]
        if self.acc_out:
            item_store_acc(acc, thr_s, 2 if self.arm == POPC else 1, self.out,
                           out_row, item_rows, col0, cols, self.n % 2 == 0)
        else:
            item_store_codes(acc, thr_s, cols_pad, self.nthr, self.out,
                             out_row, item_rows, col0, cols,
                             self.n % VEC == 0 and col0 % VEC == 0
                             and cols % VEC == 0)

    def blocks(self):
        return -(-self.m // self.tile) * -(-self.n // self.n_chunk)

    def smem_of(self, tile):
        self.raw_bytes = round_up(tile * self.kw * 4 + MMA_K, VEC)
        return self.n_chunk * self.w_pitch + \
            epilogue_smem(self.thr_rows, self.n_chunk) + 2 * self.raw_bytes

    def stage_weights(self, smem, wsm, nc0, ncols):
        wb = WORD_BYTES[self.arm]
        for idx in range(self.kw * ncols):
            c, col = divmod(idx, ncols)
            stage_word(self.arm, self.w[c * self.n + nc0 + col], smem,
                       wsm + col * self.w_pitch + c * wb)
        tail = (self.kb32 - self.kw * wb) // 4
        for idx in range(ncols * tail):
            col, j = divmod(idx, tail)
            d = wsm + col * self.w_pitch + self.kw * wb + 4 * j
            smem[d:d + 4] = 0

    def stage_epilogue(self, smem, wsm, cols_pad, nc0, ncols, ones_s=None):
        thr_s = np.empty(self.thr_rows * cols_pad, np.int64)
        for n in range(cols_pad):
            add = 0
            if n < ncols:
                if self.arm == POPC and ones_s is not None:
                    add = 2 * int(ones_s[n]) - self.k
                elif self.arm == POPC:
                    row = smem[wsm + n * self.w_pitch:
                               wsm + n * self.w_pitch + self.kb32]
                    add = 2 * int(BITCOUNT[row.view(np.uint8)].sum()) - self.k
                else:
                    add = self.pad_term
            if self.acc_out:
                thr_s[n] = add
                continue
            for t in range(self.nthr):
                x = THR_NEVER
                if n < ncols:
                    x = int(self.thr[t, nc0 + n]) + add
                    if self.arm == POPC:
                        x = (x + 1) >> 1
                    x = min(max(x, -THR_NEVER - 1), THR_NEVER)
                thr_s[t * cols_pad + n] = x
        return thr_s

    def copy_words(self, smem, tile, raw):
        row0 = tile * self.tile
        words = min(self.tile, self.m - row0) * self.kw
        assert 4 * words + MMA_K <= self.raw_bytes
        src = self.a[row0 * self.kw:row0 * self.kw + words]
        assert (row0 * self.kw * 4) % VEC == 0, "the run starts on 16 bytes"
        smem[raw:raw + 4 * words] = src.view(np.int8)

    def block(self, bx, by, rng):
        smem = rng.integers(-128, 128, size=self.smem_bytes).astype(np.int8)
        arm = self.arm
        cols_pad = round_up(self.n_chunk, ITEM_COLS)
        wsm = 0
        raw0 = self.n_chunk * self.w_pitch + self.thr_rows * cols_pad * 4 \
            + WARPS * STAGE_BYTES
        raw1 = raw0 + self.raw_bytes
        assert raw1 + self.raw_bytes == self.smem_bytes
        ntiles = -(-self.m // self.tile)
        steps = self.kb32 // MMA_K
        g, t = LANES >> 2, LANES & 3
        for nc0 in range(by * self.n_chunk, self.n,
                         self.grid_y * self.n_chunk):
            ncols = min(self.n_chunk, self.n - nc0)
            self.stage_weights(smem, wsm, nc0, ncols)
            tile, cur = bx, 0
            if tile < ntiles:
                self.copy_words(smem, tile, raw0)
            thr_s = self.stage_epilogue(smem, wsm, cols_pad, nc0, ncols)
            while tile < ntiles:
                row0 = tile * self.tile
                rows = min(self.tile, self.m - row0)
                nxt = tile + self.grid
                raw_cur = raw1 if cur else raw0
                if nxt < ntiles:
                    self.copy_words(smem, nxt, raw0 if cur else raw1)
                cur ^= 1
                m_items = -(-rows // ITEM_ROWS)
                n_items = -(-ncols // ITEM_COLS)
                for item in range(m_items * n_items):    # any warp's item
                    mi, ni = item % m_items, item // m_items
                    m0, n0 = mi * ITEM_ROWS, ni * ITEM_COLS
                    cols = min(ITEM_COLS, ncols - n0)
                    b_addr = []
                    for jp in range(4):
                        n = np.minimum(n0 + 16 * jp + b_lane_col(LANES),
                                       ncols - 1)
                        b_addr.append(wsm + n * self.w_pitch
                                      + b_lane_k(LANES))
                    acc = np.zeros((2, 8, 32, 4), np.int64)
                    ra = np.zeros((2, 32, 4), np.int64)
                    if arm == POPC:
                        item_popc(acc, ra, smem,
                                  raw_cur + 4 * ((m0 + g) * self.kw + t),
                                  self.kw, b_addr, steps, cols)
                    else:
                        item_decode(arm, acc, smem,
                                    raw_cur + 4 * (m0 + g) * self.kw,
                                    self.kw, b_addr, steps, cols)
                    self.item_finish(acc, ra, thr_s[n0:], cols_pad, row0 + m0,
                                     min(ITEM_ROWS, rows - m0), nc0 + n0,
                                     cols)
                tile += self.grid

    def run(self):
        rng = np.random.default_rng(97)
        for by in range(self.grid_y):
            for bx in range(self.grid):
                if self.slice:
                    self.sliced_block(bx, rng)
                else:
                    self.block(bx, by, rng)
        return self.out


def _packed_inputs(rng, m, k, n, bits, nthr, w_binary=False):
    """Packed operands of random levels, and sorted thresholds within one
    standard deviation of the accumulator (None with nthr = 0)."""
    if bits == 1:
        a = packing.np_pack_bits(rng.choice([-1, 1], size=(m, k)), axis=-1)
        w = packing.np_pack_bits(rng.choice([-1, 1], size=(k, n)), axis=0)
        sd = int(k ** .5)
    else:
        a = packing.np_pack_codes2(rng.integers(0, 4, size=(m, k)), axis=-1)
        wc = rng.integers(1, 3, size=(k, n)) if w_binary else \
            rng.integers(0, 4, size=(k, n))
        w = packing.np_pack_codes2(wc, axis=0)
        sd = int(k ** .5 * 5 ** .5 * (1 if w_binary else 5 ** .5))
    thr = None
    if nthr:
        thr = np.sort(rng.integers(-sd, sd + 1, size=(nthr, n)),
                      axis=0).astype(np.int32)
    return a, w, thr


def _plain(a, w, thr, k, bits, route):
    return matmul.packed_matmul_plain(
        packing.words_to_tensor(a), packing.words_to_tensor(w),
        None if thr is None else torch.from_numpy(thr), k=k, bits=bits,
        route=route).numpy()


PACKED_CASES = {
    # name: (route, bits, m, k, n, nthr, tile, n_chunk, sms, resident)
    "vpu Kw=18 (CNV conv1), two tiles a block": ("vpu", 1, 150, 576, 64, 1,
                                                 64, None, 1, 2),
    "vpu Kw=1, K=27": ("vpu", 1, 40, 27, 16, 1, None, None, 2, 2),
    "vpu Kw=5, ragged K, N=10 int32": ("vpu", 1, 33, 150, 10, 0, None, None,
                                       1, 2),
    "vpu Kw=25, N=100, chunks on the grid": ("vpu", 1, 70, 784, 100, 1, 32,
                                             48, 8, 2),
    "vpu Kw=8, N=300, chunks in the block": ("vpu", 1, 37, 256, 300, 1, 32,
                                             128, 1, 1),
    "vpu M=1": ("vpu", 1, 1, 512, 72, 1, None, None, 2, 2),
    "vpu M=7, odd N int32": ("vpu", 1, 7, 96, 9, 0, None, None, 2, 2),
    "vpu few rows, N=200: smaller blocks": ("vpu", 1, 40, 256, 200, 1, None,
                                            None, 8, 2),
    "mxu bits=1 Kw=18, two tiles": ("mxu", 1, 70, 576, 64, 1, 32, None, 1, 2),
    "mxu bits=1 ragged K=45, N=10 int32": ("mxu", 1, 33, 45, 10, 0, None,
                                           None, 1, 2),
    "mxu_rm bits=1 Kw=5, N=100, chunks": ("mxu_rm", 1, 40, 150, 100, 1, 32,
                                          48, 1, 1),
    "mxu bits=2 Kw=36 (W2A2 conv1), nthr=3": ("mxu", 2, 66, 576, 64, 3, 32,
                                              None, 1, 2),
    "mxu bits=2 ragged K=27, N=24": ("mxu", 2, 35, 27, 24, 3, None, None, 2,
                                     2),
    "mxu bits=2 odd Kw=5, K=70, N=24": ("mxu", 2, 35, 70, 24, 3, None, None,
                                        2, 2),
    "mxu bits=2 K=200 int32, N=136": ("mxu", 2, 9, 200, 136, 0, None, 64, 1,
                                      2),
}


@pytest.mark.parametrize("case", list(PACKED_CASES))
def test_packed_kernel_arithmetic_equals_plain(case):
    route, bits, m, k, n, nthr, tile, n_chunk, sms, res = PACKED_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    a, w, thr = _packed_inputs(rng, m, k, n, bits, nthr)
    want = _plain(a, w, thr, k, bits, route)
    emu = PackedEmu(a, w, thr, k, bits, route, tile=tile, n_chunk=n_chunk,
                    sms=sms, resident=res)
    got = emu.run()
    assert len(np.unique(want)) > 1, "a degenerate case"
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


SLICED_CASES = {
    # name: (route, bits, m, k, n, nthr, slice_words, sms)
    "vpu Kw=18 in slices of 8, two units a block": ("vpu", 1, 300, 576, 64,
                                                    1, 8, 1),
    "vpu Kw=21 (K=650), N=300 int32, chunks": ("vpu", 1, 70, 650, 300, 0, 16,
                                               2),
    "mxu bits=1 Kw=18 in slices of 8": ("mxu", 1, 70, 576, 24, 1, 8, 2),
    "mxu_rm bits=1 ragged K=300 int32, N=10": ("mxu_rm", 1, 33, 300, 10, 0, 8,
                                               1),
    "mxu bits=2 odd Kw=19 (K=600), nthr=3, N=100": ("mxu", 2, 40, 600, 100, 3,
                                                    8, 2),
    "vpu K=30,000: the launcher slices of itself": ("vpu", 1, 5, 30000, 8, 1,
                                                    None, 2),
    "mxu bits=2 K=9,500: the launcher slices of itself": ("mxu", 2, 3, 9500,
                                                          12, 3, None, 2),
}


@pytest.mark.parametrize("case", list(SLICED_CASES))
def test_packed_sliced_kernel_arithmetic_equals_plain(case):
    """A K that no block can hold whole rows of is walked in slices, the
    accumulators, popc(a) and popc(w) kept across them."""
    route, bits, m, k, n, nthr, slice_words, sms = SLICED_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    a, w, thr = _packed_inputs(rng, m, k, n, bits, nthr)
    want = _plain(a, w, thr, k, bits, route)
    emu = PackedEmu(a, w, thr, k, bits, route, sms=sms,
                    slice_words=slice_words)
    assert emu.slice and emu.kw > emu.slice, "the case must take slices"
    got = emu.run()
    assert len(np.unique(want)) > 1, "a degenerate case"
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("x", range(16))
def test_levels1_arithmetic(x):
    """Whatever lies above the nibble, the four bytes are its bits as ±1."""
    want = [2 * ((x >> i) & 1) - 1 for i in range(4)]
    for above in (0, 0xabcdef0, 0xfffffff):
        assert levels1(x | (above << 4)) == want


def test_packed_w1a2_words_codes_1_and_2():
    """±1 weights of a W1A2 layer are stored as 2-bit codes 1 / 2."""
    rng = np.random.default_rng(12)
    a, w, thr = _packed_inputs(rng, 40, 100, 48, 2, 3, w_binary=True)
    got = PackedEmu(a, w, thr, 100, 2, "mxu").run()
    np.testing.assert_array_equal(got, _plain(a, w, thr, 100, 2, "mxu"))


@pytest.mark.parametrize("route,bits", [("vpu", 1), ("mxu", 1), ("mxu", 2)])
def test_packed_folded_thresholds_keep_the_sentinels(route, bits):
    """Thresholds at the ends of int32 and at THR_ALWAYS / THR_NEVER survive
    the fold onto the raw accumulator (64-bit sum, clamped), whatever the
    `.and` identity's column constant adds."""
    from bnn_pynq_tpu_torch.ops.thresholds import THR_ALWAYS, THR_NEVER as TN
    rng = np.random.default_rng(13 + bits)
    k, n = 150, 48
    a, w, thr = _packed_inputs(rng, 40, k, n, bits, 3)
    thr[0, ::3] = -2 ** 31
    thr[2, ::2] = 2 ** 31 - 1
    thr[:, 5] = 2 ** 31 - 1
    thr[:, 7] = -2 ** 31
    thr[:, 9] = TN
    thr[:, 11] = THR_ALWAYS
    want = _plain(a, w, thr, k, bits, route)
    got = PackedEmu(a, w, thr, k, bits, route).run()
    np.testing.assert_array_equal(got, want)
    assert (want[:, [5, 9]] == 0).all() and (want[:, [7, 11]] == 3).all()


def test_packed_and_identity_row_term_counts_real_words_only():
    """popc(a) must not count what lies behind a row's last word: with all
    of a's bits set the next row's words (and the garbage behind the tile)
    sit in the same 256-bit step."""
    rng = np.random.default_rng(14)
    m, k, n = 33, 96, 16                      # Kw = 3: 5 words of tail a step
    a = np.full((m, 3), 0xffffffff, np.uint32)
    w = packing.np_pack_bits(rng.choice([-1, 1], size=(k, n)), axis=0)
    want = _plain(a, w, None, k, 1, "vpu")
    np.testing.assert_array_equal(PackedEmu(a, w, None, k, 1, "vpu").run(),
                                  want)


def test_packed_main_path_tiles_fit_shared_memory():
    """The launcher's sizing at the eight packed layers of CNV-W1A1 (batch
    1024, 132 SMs) on both arms: a tile with an item for each warp where the
    rows are many, 64 columns and 32 rows a block where they are few (so
    that every SM has a block), column chunks where the decoded weights do
    not fit; and at one row."""
    z = np.zeros

    def plan(m, k, n, route, bits=1):
        kw = k * bits // 32
        return PackedEmu(z((m, kw), np.uint32), z((kw, n), np.uint32),
                         z((1, n), np.int32), k, bits, route, sms=132,
                         resident=2)
    for m, k, n, tile, n_chunk in ((802816, 576, 64, 256, 64),
                                   (147456, 576, 128, 128, 128),
                                   (102400, 1152, 128, 128, 128),
                                   (9216, 1152, 256, 64, 256),
                                   (1024, 2304, 256, 32, 64),
                                   (1024, 256, 512, 32, 64),
                                   (1024, 512, 512, 32, 64),
                                   (1024, 512, 10, 32, 16)):
        emu = plan(m, k, n, "vpu")
        assert (emu.tile, emu.n_chunk) == (tile, n_chunk), (m, k, n)
        assert 2 * emu.smem_bytes <= MAX_SMEM
        emu = plan(m, k, n, "mxu")
        assert emu.smem_bytes <= MAX_SMEM
        assert (emu.tile, emu.n_chunk) == (tile, n_chunk) or k >= 1152
    emu = plan(102400, 1152, 128, "mxu")          # conv3: an item a warp
    assert (emu.tile, emu.n_chunk) == (128, 128)
    emu = plan(9216, 1152, 256, "mxu")            # conv4: two chunks
    assert (emu.tile, emu.n_chunk) == (128, 128)
    emu = plan(1, 512, 512, "vpu")                # one row: a block a chunk
    assert (emu.tile, emu.n_chunk, emu.grid, emu.grid_y) == (32, 64, 1, 8)
    emu = plan(1024, 1024, 1024, "mxu")           # LFC: chunks of 64
    assert emu.smem_bytes <= MAX_SMEM and emu.n_chunk == 64


# -- conv_direct.cu::chain_kernel -------------------------------------------------

CHAIN_WARPS = 16
CHAIN_THREADS = 32 * CHAIN_WARPS
CHAIN_WEIGHT_BYTES = 76 * 1024
CHAIN_PATCH_BYTES = 48 * 1024


def item_store_smem(acc, thr_s, cols_pad, nthr, smem, dst, pitch, rows,
                    cols):
    """Codes of an item into the next layer's input: dst = the byte address
    of item row 0, column 0."""
    g, t = LANES >> 2, LANES & 3
    assert dst % 2 == 0 and pitch % 2 == 0
    for mb in range(2):
        for j in range(8):
            code = np.zeros((2, 2, 32), np.int64)
            for k in range(nthr):
                th = [thr_s[k * cols_pad + 8 * j + 2 * t + c] for c in (0, 1)]
                for h in range(2):
                    for c in range(2):
                        code[h, c] += acc[mb, j, :, 2 * h + c] >= th[c]
            for h in range(2):
                for lane in range(32):
                    rr = 16 * mb + 8 * h + g[lane]
                    n = 8 * j + 2 * t[lane]
                    if rr >= rows or n >= cols:
                        continue
                    o = dst + rr * pitch + n
                    smem[o] = code[h, 0, lane]
                    if n + 1 < cols:
                        smem[o + 1] = code[h, 1, lane]


class ChainEmu:
    """`bnn_conv_chain_direct`'s fused kernel: the plan, then every block.
    sms: the card's SM count (caps the images a tile holds); max_smem: the
    shared memory a block may use (small values force the plan's limits)."""

    def __init__(self, x, weights, thresholds, kernel, abits, input_levels,
                 sms=2, max_smem=MAX_SMEM):
        self.x = x.reshape(-1)
        self.b, self.h, self.w, self.c = x.shape
        self.ksize, self.input_levels = kernel, input_levels
        self.off = 1 if abits == 1 else 3
        self.nthr = thresholds[0].shape[0]
        self.layers = []
        halo = kernel - 1
        hin, win, cin = self.h, self.w, self.c
        per_img, w_bytes, max_cols, patch_pitch = [0, 0], 0, 0, 0
        for j, (w, thr) in enumerate(zip(weights, thresholds)):
            k32 = w.nk32.shape[1]
            assert k32 == round_up(kernel * kernel * cin, MMA_K)
            L = dict(wt=w.nk32.numpy().reshape(-1), wsum=w.wsum.numpy(),
                     thr=thr.numpy(), k32=k32, n_out=w.kn.shape[1])
            L["gather"] = cin % MMA_K != 0
            L["in_pitch"] = cin if (j == 0 and L["gather"]) \
                else padded_pitch(cin)
            L["a_pitch"] = L["w_pitch"] = padded_pitch(k32)
            L["n_chunk"] = round_up(L["n_out"], 8)
            while L["n_chunk"] > 8 and \
                    L["n_chunk"] * L["w_pitch"] > CHAIN_WEIGHT_BYTES:
                L["n_chunk"] = round_up(L["n_chunk"] // 2, 8)
            w_bytes = max(w_bytes, L["n_chunk"] * L["w_pitch"])
            max_cols = max(max_cols, L["n_chunk"])
            if j > 0 or not L["gather"]:
                per_img[j % 2] = max(per_img[j % 2],
                                     hin * win * L["in_pitch"])
            if L["gather"]:
                patch_pitch = max(patch_pitch, L["a_pitch"])
            hin, win, cin = hin - halo, win - halo, L["n_out"]
            self.layers.append(L)
        self.oh, self.ow = hin, win
        self.cols_pad = round_up(max_cols, ITEM_COLS)
        self.ptile = min(CHAIN_THREADS, max(
            ITEM_ROWS, CHAIN_PATCH_BYTES // max(patch_pitch, 1)
            // ITEM_ROWS * ITEM_ROWS))
        self.patch_bytes = self.ptile * patch_pitch
        fixed = w_bytes + epilogue_smem(self.nthr, max_cols, CHAIN_WARPS) \
            + self.patch_bytes

        def smem_of(imgs):
            return fixed + imgs * (per_img[0] + per_img[1])

        self.fused = smem_of(1) <= max_smem
        cap = max(1, min(self.b, -(-self.b // sms)))
        imgs = 1
        while imgs < cap and smem_of(imgs + 1) <= max_smem:
            imgs += 1
        self.imgs, self.w_bytes = imgs, w_bytes
        self.region_bytes = [imgs * per_img[0], imgs * per_img[1]]
        self.smem_bytes = smem_of(imgs)
        self.grid = min(-(-self.b // imgs), sms)
        self.out = np.full((self.b * self.oh * self.ow,
                            self.layers[-1]["n_out"]), -1, np.int8)

    def chain_pixel(self, g, p, pitch):
        i, q = divmod(p, g["map"])
        y, xx = divmod(q, g["wout"])
        return ((i * g["hin"] + y) * g["win"] + xx) * pitch

    def gather(self, g, src, base, pitch, p0, count, smem, buf, a_pitch):
        """src: the array the layer's input lies in (the images in device
        memory, or shared memory), base: the input's first byte in it."""
        slots = self.ptile
        rows = pitch == g["cin"]
        run = self.ksize * g["cin"] if rows else g["cin"]
        nruns = self.ksize if rows else self.ksize * self.ksize
        for tid in range(CHAIN_THREADS):
            r = tid % slots
            if r >= count:
                continue
            pix = base + self.chain_pixel(g, p0 + r, pitch)
            for q in range(tid // slots, nruns, CHAIN_THREADS // slots):
                ki, kj = (q, 0) if rows else divmod(q, self.ksize)
                s = pix + (ki * g["win"] + kj) * pitch
                d = buf + r * a_pitch + q * run
                smem[d:d + run] = src[s:s + run]

    def block(self, bx, rng):
        smem = rng.integers(-128, 128, size=self.smem_bytes).astype(np.int8)
        wsm = 0
        stages = self.w_bytes + self.nthr * self.cols_pad * 4
        region = [stages + CHAIN_WARPS * STAGE_BYTES, 0]
        region[1] = region[0] + self.region_bytes[0]
        patches = region[1] + self.region_bytes[1]
        assert patches + self.patch_bytes == self.smem_bytes
        ntiles = -(-self.b // self.imgs)
        for tile in range(bx, ntiles, self.grid):
            img0 = tile * self.imgs
            imgs = min(self.imgs, self.b - img0)
            g = dict(hin=self.h, win=self.w, cin=self.c, wout=0, map=0)
            x0 = img0 * self.h * self.w * self.c
            L0 = self.layers[0]
            if not L0["gather"]:
                cv = self.c // VEC
                for i in range(imgs * self.h * self.w * cv):
                    pix, v = divmod(i, cv)
                    d = region[0] + pix * L0["in_pitch"] + v * VEC
                    assert d + VEC <= region[0] + self.region_bytes[0]
                    smem[d:d + VEC] = self.x[x0 + i * VEC:x0 + (i + 1) * VEC]
            for j, L in enumerate(self.layers):
                last = j + 1 == len(self.layers)
                g["wout"] = g["win"] - self.ksize + 1
                g["map"] = (g["hin"] - self.ksize + 1) * g["wout"]
                pixels = imgs * g["map"]
                from_x = j == 0 and L["gather"]
                src, base = (self.x, x0) if from_x else (smem, region[j % 2])
                nxt = region[(j + 1) % 2]
                out_pitch = 0 if last else self.layers[j + 1]["in_pitch"]
                if not last:
                    assert pixels * out_pitch <= \
                        self.region_bytes[(j + 1) % 2]
                ep = (L["thr"], L["wsum"], L["n_out"], self.off,
                      not (j == 0 and self.input_levels))
                ks = 1 if L["gather"] else self.ksize
                c_eff = L["k32"] if L["gather"] else g["cin"]
                kvec = L["k32"] // VEC
                ptile = self.ptile if L["gather"] else pixels
                for nc0 in range(0, L["n_out"], L["n_chunk"]):
                    ncols = min(L["n_chunk"], L["n_out"] - nc0)
                    thr_s = stage_thresholds(self.cols_pad, ep, nc0, ncols)
                    for i in range(ncols * kvec):
                        n, v = divmod(i, kvec)
                        d = wsm + n * L["w_pitch"] + v * VEC
                        assert d + VEC <= self.w_bytes
                        s = nc0 * L["k32"] + i * VEC
                        smem[d:d + VEC] = L["wt"][s:s + VEC]
                    for pt0 in range(0, pixels, ptile):
                        count = min(ptile, pixels - pt0)
                        if L["gather"]:
                            self.gather(g, src, base, L["in_pitch"], pt0,
                                        count, smem, patches, L["a_pitch"])
                        m_items = -(-count // ITEM_ROWS)
                        n_items = -(-ncols // ITEM_COLS)
                        for item in range(m_items * n_items):
                            mi, ni = item % m_items, item // m_items
                            m0, n0 = mi * ITEM_ROWS, ni * ITEM_COLS
                            cols = min(ITEM_COLS, ncols - n0)
                            a_addr, b_addr = [], []
                            for mb in range(2):
                                m = np.minimum(
                                    m0 + 16 * mb + a_lane_row(LANES),
                                    count - 1)
                                if L["gather"]:
                                    at = patches + m * L["a_pitch"]
                                else:
                                    at = base + np.array(
                                        [self.chain_pixel(g, pt0 + int(q),
                                                          L["in_pitch"])
                                         for q in m])
                                a_addr.append(at + a_lane_k(LANES))
                            for jp in range(4):
                                n = np.minimum(
                                    n0 + 16 * jp + b_lane_col(LANES),
                                    ncols - 1)
                                b_addr.append(wsm + n * L["w_pitch"]
                                              + b_lane_k(LANES))
                            acc = np.zeros((2, 8, 32, 4), np.int64)
                            koff = 0
                            for ki in range(ks):
                                for kj in range(ks):
                                    tap = (ki * g["win"] + kj) * L["in_pitch"]
                                    item_mma(acc, smem,
                                             [a + tap for a in a_addr],
                                             [b + koff for b in b_addr],
                                             c_eff // MMA_K, cols)
                                    koff += c_eff
                            col0 = nc0 + n0
                            rows = min(ITEM_ROWS, count - m0)
                            if last:
                                item_store_codes(
                                    acc, thr_s[n0:], self.cols_pad,
                                    self.nthr, self.out,
                                    img0 * g["map"] + pt0 + m0, rows, col0,
                                    cols, L["n_out"] % VEC == 0
                                    and col0 % VEC == 0 and cols % VEC == 0)
                            else:
                                item_store_smem(
                                    acc, thr_s[n0:], self.cols_pad,
                                    self.nthr, smem,
                                    nxt + (pt0 + m0) * out_pitch + col0,
                                    out_pitch, rows, cols)
                g["hin"] -= self.ksize - 1
                g["win"] -= self.ksize - 1
                g["cin"] = L["n_out"]

    def run(self):
        assert self.fused
        rng = np.random.default_rng(96)
        for bx in range(self.grid):
            self.block(bx, rng)
        return self.out.reshape(self.b, self.oh, self.ow, -1)


CHAIN_CASES = {
    # name: (wbits, abits, b, h, kernel, channels, input_levels, sms)
    "w1a1 image C=3, two layers": (1, 1, 3, 9, 3, [3, 64, 32], True, 2),
    "w2a2 image C=3, nthr=3, N=10": (2, 2, 2, 8, 3, [3, 32, 10], True, 1),
    "w1a1 codes C=64 in place, N=72": (1, 1, 5, 7, 3, [64, 32, 72], False, 2),
    "w2a2 three layers": (2, 2, 3, 9, 3, [32, 32, 64, 16], False, 2),
    "w1a1 one layer, C=32, N=48": (1, 1, 4, 6, 3, [32, 48], False, 3),
    "w1a1 one layer, image": (1, 1, 2, 7, 3, [3, 100], True, 2),
    "w1a1 C=24 gathered, then N=24 gathered": (1, 1, 2, 8, 3, [24, 24, 16],
                                               False, 1),
    "w2a2 5x5, C=32": (2, 2, 2, 11, 5, [32, 32, 8], False, 2),
    "w1a1 weight chunks (K=1152, N=136)": (1, 1, 1, 6, 3, [128, 136, 32],
                                           False, 1),
}


@pytest.mark.parametrize("case", list(CHAIN_CASES))
def test_chain_kernel_arithmetic_equals_plain(case):
    wbits, abits, b, h, k, chans, levels, sms = CHAIN_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    ws, ts = _layers(rng, chans, wbits, abits, k=k, image=levels)
    if levels:
        x = rng.integers(-128, 128, size=(b, h, h, chans[0]))
    else:
        x = rng.integers(0, 2 ** abits, size=(b, h, h, chans[0]))
    x = torch.from_numpy(x.astype(np.int8))
    pw, pt = _port(ws, ts)
    want = conv_direct.conv_chain_direct_plain(
        x, pw, pt, kernel=k, abits=abits, input_levels=levels)
    emu = ChainEmu(x.numpy(), pw, pt, k, abits, levels, sms=sms)
    got = emu.run()
    assert len(np.unique(want.numpy())) > 1, "a degenerate case"
    np.testing.assert_array_equal(got, want.numpy())


def test_chain_plan_at_the_main_shapes():
    """CNV's two chains at batch 1024 on 132 SMs: whole images fit, two of
    the 32×32 images and three of the 14×14 maps a tile; conv3's weights go
    in two chunks; a 64×64×64 map does not fit and takes the other branch."""
    def plan(b, h, chans, levels):
        ws = [weight_matrix(torch.zeros((9 * ci, co), dtype=torch.int8))
              for ci, co in zip(chans[:-1], chans[1:])]
        ts = [torch.zeros((1, co), dtype=torch.int32) for co in chans[1:]]
        return ChainEmu(np.zeros((b, h, h, chans[0]), np.int8), ws, ts, 3, 1,
                        levels, sms=132)
    emu = plan(1024, 32, [3, 64, 64], True)
    assert emu.fused and emu.imgs == 2 and emu.smem_bytes <= MAX_SMEM
    assert [L["gather"] for L in emu.layers] == [True, False]
    assert [L["n_chunk"] for L in emu.layers] == [64, 64]
    emu = plan(1024, 14, [64, 128, 128], False)
    assert emu.fused and emu.imgs == 3 and emu.smem_bytes <= MAX_SMEM
    assert [L["n_chunk"] for L in emu.layers] == [128, 64]
    assert plan(1, 14, [64, 128, 128], False).imgs == 1
    assert not plan(2, 64, [64, 64, 64], False).fused
