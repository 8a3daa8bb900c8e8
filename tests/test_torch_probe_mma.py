"""The two dot probes on the tensor cores: their index arithmetic on the CPU.

`csrc/mosaic_probes.cu::shifted_dot_kernel` computes
`out[r, o] = Σ_i Σ_c x[r+i, c] · w[i·C + c, o]` for `bnn_probe_lane_concat`
and `bnn_probe_scratch_lane_store` on `mma.sync.m16n8k32.s8` through
`csrc/mma_tile.cuh`, and runs only on a card. This file transliterates it
into numpy, statement by statement, with the fragment, ldmatrix and store
helpers of `tests/test_torch_mma_layout.py`:

- the launcher: the staged K's segments (one of taps·C for the scratch
  probe, one a tap of Cp = round_up(C, 32) for the concat probe), the
  pitches, the shared-memory layout and its limit, the grid (row tiles ×
  64-column chunks) and the k32 steps each of a block's 8 warps takes;
- the A tile: the scratch probe's patch at C-byte offsets, the concat
  probe's x rows, both with their zero padding, a bulk copy a row or by
  bytes;
- the weights transposed 4 × 4 bytes a thread (`__byte_perm`), zero behind
  K, behind n and behind each tap for the concat probe;
- the A addresses (segment s of the concat probe s rows down), the warps'
  partial sums added into a shared int32 tile, the store of the tile with
  its row and column tails.

Shared memory starts as garbage, so a byte the kernel must never depend on
shows up as a wrong sum. Every result is held, exactly, against the plain
versions and against JAX's probes run in Pallas interpret mode (the tool's
shape constants patched on its module object, as `tests/test_torch_probes.py`
patches its `pallas_call`).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_pynq_tpu_torch.ops import probes
from tests.test_torch_mma_layout import (ITEM_COLS, ITEM_ROWS, LANES,
                                         MAX_SMEM, MMA_K, VEC, a_lane_k,
                                         a_lane_row, b_lane_col, b_lane_k,
                                         item_mma, ldmatrix_x4, padded_pitch,
                                         round_up)
from tests.test_torch_probes import _jax_tool, _Proxy

# csrc/mosaic_probes.cu
DOT_WARPS = 8
MIN_CHUNK = 16
SMS = 132                               # the H100 SXM's
DOT_THREADS = 32 * DOT_WARPS
TILE_PITCH = ITEM_COLS + 8               # words
TILE_BYTES = ITEM_ROWS * TILE_PITCH * 4
RAW_PITCH = ITEM_COLS + VEC
STAGE_BATCH = 3
UNSET = np.iinfo(np.int32).min          # |Σ| < 2^24: never a real output


# -- the launcher -------------------------------------------------------------

class DotArgs:
    """launch_shifted_dot's DotArgs, from the shapes and the pointers'
    alignment (x_align, w_align, out_align: the addresses modulo 16)."""

    def __init__(self, m, c, taps, n, concat, x_align=0, w_align=0,
                 out_align=0, sms=SMS):
        self.m, self.c, self.taps, self.n = m, c, taps, n
        self.concat = concat
        if concat:
            self.seg_len = c
            self.seg_pad = round_up(c, MMA_K)
            self.nseg = taps
            self.a_rows = ITEM_ROWS + taps - 1
            self.a_pitch = padded_pitch(self.seg_pad)
            self.a_seg = self.a_pitch            # tap i: i rows down
        else:
            self.seg_len = taps * c
            self.seg_pad = round_up(taps * c, MMA_K)
            self.nseg = 1
            self.a_rows = ITEM_ROWS
            self.a_pitch = padded_pitch(self.seg_pad)
            self.a_seg = self.seg_pad
        self.w_pitch = padded_pitch(self.nseg * self.seg_pad)
        self.raw_off = self.a_rows * self.a_pitch + ITEM_COLS * self.w_pitch
        self.tile_off = self.raw_off + taps * c * RAW_PITCH
        self.bar_off = self.tile_off + TILE_BYTES
        self.smem = self.bar_off + 16
        self.x_vec = c % VEC == 0 and x_align % VEC == 0
        self.w_wide = n % VEC == 0 and w_align % VEC == 0
        self.out_vec = n % 4 == 0 and out_align % VEC == 0
        tiles = -(-m // ITEM_ROWS)
        self.chunk, self.gshift = ITEM_COLS, 2
        while self.chunk > MIN_CHUNK and tiles * -(-n // self.chunk) < sms:
            self.chunk //= 2
            self.gshift -= 1
        self.grid = (tiles, -(-n // self.chunk))

    def fits(self):
        return self.smem <= MAX_SMEM

    def warp_runs(self, warp):
        """(segment, first step, end step) of each item_mma call of a warp:
        its share of the k32 steps, cut at the segment boundaries."""
        seg_steps = self.seg_pad // MMA_K
        steps = self.nseg * seg_steps
        s, s_end = warp * steps // DOT_WARPS, (warp + 1) * steps // DOT_WARPS
        runs = []
        while s < s_end:
            seg = s // seg_steps
            end = min(s_end, (seg + 1) * seg_steps)
            runs.append((seg, s, end))
            s = end
        return runs


# -- shared-memory helpers ----------------------------------------------------

def byte_perm(x, y, sel):
    """__byte_perm(x, y, sel) for selectors 0-7 (no sign replication)."""
    x, y = np.asarray(x, np.uint64), np.asarray(y, np.uint64)
    src = [(x >> (8 * b)) & 0xff for b in range(4)] + \
        [(y >> (8 * b)) & 0xff for b in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << (8 * i)
    return out.astype(np.uint32)


def store_words(smem, addr, words):
    """32-bit shared stores: words[k] at byte addresses addr[k]."""
    addr = np.asarray(addr)
    assert (addr % 4 == 0).all()
    b = np.asarray(words, np.uint32).astype("<u4").view(np.uint8) \
        .reshape(-1, 4).view(np.int8)
    smem[addr[:, None] + np.arange(4)] = b


def load_words(smem, addr):
    addr = np.asarray(addr)
    assert (addr % 4 == 0).all()
    return smem[addr[:, None] + np.arange(4)].view("<i4").reshape(-1) \
        .astype(np.int64)


# -- the device routines ------------------------------------------------------

def zero_tail(smem, base, rows, pitch, real, frm, to):
    tail = to - frm
    idx = np.arange(real * tail)
    r = idx // tail
    smem[base + r * pitch + frm + idx - r * tail] = 0
    vecs = to // VEC
    idx = np.arange((rows - real) * vecs)
    r = real + idx // vecs
    d = base + r * pitch + (idx % vecs) * VEC
    smem[d[:, None] + np.arange(VEC)] = 0


def copy_runs(p, smem, a_s, x, row0, count, length):
    """Run r: `length` bytes at x + (row0 + r)·c into A-tile row r (a bulk
    copy a run, or a byte a lane)."""
    for r in range(count):
        src = (row0 + r) * p.c + np.arange(length)
        smem[a_s + r * p.a_pitch + np.arange(length)] = x[src]


def stage_patch(p, smem, a_s, x, row0, rows):
    """x: the flat int8 input, exactly as long as the kernel may read."""
    copy_runs(p, smem, a_s, x, row0, rows, p.taps * p.c)
    zero_tail(smem, a_s, p.a_rows, p.a_pitch, rows, p.taps * p.c, p.seg_pad)


def stage_x_rows(p, smem, a_s, x, row0):
    real = min(p.a_rows, p.m + p.taps - 1 - row0)
    copy_runs(p, smem, a_s, x, row0, real, p.c)
    zero_tail(smem, a_s, p.a_rows, p.a_pitch, real, p.c, p.seg_pad)


def weight_word(p, w, row, col):
    """Vectorised over the threads: row (-1: a zero row), col."""
    row, col = np.asarray(row), np.asarray(col)
    out = np.zeros(row.shape, np.uint32)
    live = (row >= 0) & (col < p.n)
    base = row * p.n + col
    u8 = w.view(np.uint8)
    for b in range(4):                   # bytes up to n
        take = live & (col + b < p.n)
        out[take] |= u8[base[take] + b].astype(np.uint32) << (8 * b)
    return out


def weight_row16(p, w, row, col):
    """[threads, 4] words: bytes col..col+15 of w row `row`."""
    return np.stack([weight_word(p, w, row, col + 4 * q) for q in range(4)],
                    axis=-1)


def raw_offset(s, c16):
    return s * RAW_PITCH + VEC * (c16 ^ ((s >> 3) & 3))


def stage_raw_w(p, smem, raw, w, nc0):
    """cp.async of the block's columns of every w row (w_wide)."""
    kw = p.taps * p.c
    idx = np.arange(kw << p.gshift)
    s, c16 = idx >> p.gshift, idx & ((1 << p.gshift) - 1)
    col = nc0 + c16 * VEC
    d = raw + raw_offset(s, c16)
    live = col < p.n
    src = s[live] * p.n + col[live]
    smem[d[live][:, None] + np.arange(VEC)] = w[src[:, None] + np.arange(VEC)]
    smem[d[~live][:, None] + np.arange(VEC)] = 0


def store_columns(smem, dst, pw, r0, r1, r2, r3):
    """dst: word addresses (one per thread)."""
    lo01, lo23 = byte_perm(r0, r1, 0x5140), byte_perm(r2, r3, 0x5140)
    hi01, hi23 = byte_perm(r0, r1, 0x7362), byte_perm(r2, r3, 0x7362)
    store_words(smem, 4 * dst, byte_perm(lo01, lo23, 0x5410))
    store_words(smem, 4 * (dst + pw), byte_perm(lo01, lo23, 0x7632))
    store_words(smem, 4 * (dst + 2 * pw), byte_perm(hi01, hi23, 0x5410))
    store_words(smem, 4 * (dst + 3 * pw), byte_perm(hi01, hi23, 0x7632))


def unit_coords(u, gshift):
    """(k4, 16-column group) of the weight-staging unit u."""
    return ((u >> 5) >> gshift) * 32 + (u & 31), (u >> 5) & ((1 << gshift) - 1)


def stage_weights_t(p, smem, w_s, raw, w, nc0, from_raw):
    """from_raw: kStageBatch units a thread read from the raw tile; else
    one at a time from w."""
    batch = STAGE_BATCH if from_raw else 1
    k4s = p.nseg * p.seg_pad // 4
    units = ((k4s + 31) // 32 * 32) << p.gshift
    pw = p.w_pitch // 4
    ws = w_s // 4
    tid = np.arange(DOT_THREADS)
    for base in range(0, units, batch * DOT_THREADS):
        v = []
        for b in range(batch):
            u = base + tid + b * DOT_THREADS
            k4, c16 = unit_coords(u, p.gshift)
            seg = 4 * k4 // p.seg_pad
            q = 4 * k4 - seg * p.seg_pad
            live = (u < units) & (k4 < k4s)
            rows = []
            for r in range(4):
                row = np.where(live & (q + r < p.seg_len),
                               seg * p.seg_len + q + r, -1)
                if from_raw:
                    words = np.zeros((DOT_THREADS, 4), np.uint32)
                    ok = row >= 0
                    a = raw + raw_offset(row[ok], c16[ok])
                    assert (a % VEC == 0).all()
                    words[ok] = smem[a[:, None] + np.arange(VEC)].view("<u4")
                else:
                    words = weight_row16(p, w, row, nc0 + c16 * VEC)
                rows.append(words)
            v.append(rows)
        for b in range(batch):
            u = base + tid + b * DOT_THREADS
            k4, c16 = unit_coords(u, p.gshift)
            live = (u < units) & (k4 < k4s)
            dst = ws + c16[live] * 16 * pw + k4[live]
            rows = [r[live] for r in v[b]]
            for q in range(4):
                store_columns(smem, dst + 4 * q * pw, pw,
                              *(rows[r][:, q] for r in range(4)))


def warp_bank_conflicts(p):
    """The most lanes of one warp's 32-bit shared stores that meet in a
    bank, and the most lanes of one quarter warp's 16-byte raw-tile reads
    that meet in a 16-byte bank group (7b; 7a at C % 32 == 0)."""
    k4s = p.nseg * p.seg_pad // 4
    units = ((k4s + 31) // 32 * 32) << p.gshift
    pw = p.w_pitch // 4
    stores = reads = 0
    for w0 in range(0, units, 32):
        k4, c16 = unit_coords(np.arange(w0, w0 + 32), p.gshift)
        live = k4 < k4s
        for q in range(16):              # each of a unit's 16 stores
            banks = ((c16[live] * 16 + q) * pw + k4[live]) % 32
            if banks.size:
                stores = max(stores, np.bincount(banks).max())
        for r in range(4):               # each of its 4 reads
            for l0 in range(0, 32, 8):
                sl = slice(l0, l0 + 8)
                ok = live[sl]
                groups = (raw_offset(4 * k4[sl][ok] + r, c16[sl][ok])
                          % 128) // VEC
                if groups.size:
                    reads = max(reads, np.bincount(groups).max())
    return stores, reads


def block(p, x, w, bx, by, out, rng, check=None):
    """One block of shifted_dot_kernel<concat>."""
    smem = rng.integers(-128, 128, size=p.smem).astype(np.int8)
    row0, nc0 = bx * ITEM_ROWS, by * p.chunk
    rows = min(ITEM_ROWS, p.m - row0)
    cols = min(p.chunk, p.n - nc0)
    a_s, w_s, raw, tile = 0, p.a_rows * p.a_pitch, p.raw_off, p.tile_off

    wide = p.w_wide
    if p.concat:
        stage_x_rows(p, smem, a_s, x, row0)
    else:
        stage_patch(p, smem, a_s, x, row0, rows)
    if wide:
        stage_raw_w(p, smem, raw, w, nc0)
    else:
        stage_weights_t(p, smem, w_s, raw, w, nc0, from_raw=False)
    smem[tile:tile + TILE_BYTES] = 0     # int4 stores, every thread
    if wide:                             # after the copies and a barrier
        stage_weights_t(p, smem, w_s, raw, w, nc0, from_raw=True)
    if check is not None:
        check(p, smem, row0, rows, nc0)

    accs = []
    for warp in range(DOT_WARPS):
        a_base = [a_s + (16 * mb + a_lane_row(LANES)) * p.a_pitch
                  + a_lane_k(LANES) for mb in range(2)]
        b_base = [w_s + (16 * jp + b_lane_col(LANES)) * p.w_pitch
                  + b_lane_k(LANES) for jp in range(4)]
        acc = np.zeros((2, 8, 32, 4), np.int64)
        seg_steps = p.seg_pad // MMA_K
        for seg, s, end in p.warp_runs(warp):
            a_off = seg * p.a_seg + (s - seg * seg_steps) * MMA_K
            item_mma(acc, smem, [a + a_off for a in a_base],
                     [b + s * MMA_K for b in b_base], end - s, cols)
        accs.append(acc)

    # every warp adds its partial sums into the output tile (shared
    # atomics: the order does not matter), then the tile leaves 16 bytes a
    # thread
    g, t = LANES >> 2, LANES & 3
    for warp in range(DOT_WARPS):
        for mb in range(2):
            for j in range(8):
                if 8 * j >= cols:
                    continue
                for e in range(4):
                    addr = tile + ((16 * mb + 8 * (e >> 1) + g) * TILE_PITCH
                                   + 8 * j + 2 * t + (e & 1)) * 4
                    assert len(set(addr)) == 32
                    old = load_words(smem, addr)
                    store_words(smem, addr, (old + accs[warp][mb, j, :, e])
                                .astype(np.int32).view(np.uint32))
    quads = p.chunk // 4
    i = np.arange(rows * quads)
    r = i >> (p.gshift + 2)
    c = (i & (quads - 1)) * 4
    keep = c < cols
    r, c = r[keep], c[keep]
    v = load_words(smem, (tile + (r * TILE_PITCH + c)[:, None] * 4
                          + 4 * np.arange(4)).reshape(-1)).reshape(-1, 4)
    for q in range(4):                  # an int4 store where it fits, else
        ok = c + q < cols               # the elements inside the output
        out[row0 + r[ok], nc0 + c[ok] + q] = v[ok, q]


def emu_shifted_dot(x, w, m, concat, check=None, seed=7, **launch):
    """The whole launch on numpy int8 x [>= m + taps - 1, C], w [taps·C, n];
    x is cut to the m + taps - 1 rows the kernel may read. launch: the
    pointers' alignment, the card's SMs."""
    c, n = x.shape[1], w.shape[1]
    taps = w.shape[0] // c
    p = DotArgs(m, c, taps, n, concat, **launch)
    assert p.fits()
    xf = np.ascontiguousarray(x[:m + taps - 1]).reshape(-1)
    wf = np.ascontiguousarray(w).reshape(-1)
    out = np.full((m, n), UNSET, np.int32)
    rng = np.random.default_rng(seed)
    for by in range(p.grid[1]):
        for bx in range(p.grid[0]):
            block(p, xf, wf, bx, by, out, rng, check)
    return out


# -- the expected tiles -------------------------------------------------------

def check_tiles(x, w):
    """A `check` for `block`: the staged A tile and weights equal what the
    kernel's header says they hold, zeros included."""
    def check(p, smem, row0, rows, nc0):
        kp = p.nseg * p.seg_pad
        a = smem[:p.a_rows * p.a_pitch].reshape(p.a_rows, p.a_pitch)
        if p.concat:
            want = np.zeros((p.a_rows, p.seg_pad), np.int8)
            real = min(p.a_rows, p.m + p.taps - 1 - row0)
            want[:real, :p.c] = x[row0:row0 + real]
            np.testing.assert_array_equal(a[:, :p.seg_pad], want)
        else:
            want = np.zeros((ITEM_ROWS, kp), np.int8)
            for i in range(p.taps):
                want[:rows, i * p.c:(i + 1) * p.c] = \
                    x[row0 + i:row0 + i + rows]
            np.testing.assert_array_equal(a[:, :kp], want)
        ws = smem[p.a_rows * p.a_pitch:][:p.chunk * p.w_pitch] \
            .reshape(p.chunk, p.w_pitch)
        want = np.zeros((p.chunk, kp), np.int8)
        cols = min(p.chunk, p.n - nc0)
        for s in range(p.nseg):
            seg = w[s * p.seg_len:(s + 1) * p.seg_len, nc0:nc0 + cols].T
            want[:cols, s * p.seg_pad:s * p.seg_pad + p.seg_len] = seg
        np.testing.assert_array_equal(ws[:, :kp], want)
    return check


# -- the cases ----------------------------------------------------------------

# (m, C, taps, n, ones): JAX's probe shape, with its ones and with random
# int8 over the full range; the ragged case of chip_smoke.py (x (40, 20),
# w (60, 13), m 37: every scalar path); C = 48 with taps = 9 and m = 1000
# (k32 steps across tap boundaries, a partial last row tile); n = 200
# (four column chunks, the last of 8 columns)
CASES = {
    "jax_inputs": (1024, 64, 9, 64, True),
    "random": (1024, 64, 9, 64, False),
    "ragged": (37, 20, 3, 13, False),
    "c48_taps9": (1000, 48, 9, 64, False),
    "n200": (1024, 64, 9, 200, False),
}
KINDS = {"lane_concat": True, "scratch_lane_store": False}


def _inputs(case, seed=0):
    m, c, taps, n, ones = CASES[case]
    rng = np.random.default_rng(seed)
    shapes = ((m + 128, c), (taps * c, n))     # JAX's: x has M + 128 rows
    if ones:
        return [np.ones(s, np.int8) for s in shapes]
    return [rng.integers(-128, 128, size=s).astype(np.int8) for s in shapes]


def _run_jax_probe(monkeypatch, name, case, arrays):
    """JAX's probe in interpret mode at the case's shape, fed `arrays`."""
    m, c, taps, n, _ = CASES[case]
    mod = _jax_tool()
    pl = mod.pl
    made = iter(arrays)
    monkeypatch.setattr(mod, "pl", _Proxy(pl, pallas_call=functools.partial(
        pl.pallas_call, interpret=True)))
    monkeypatch.setattr(mod, "jnp", _Proxy(
        jnp, ones=lambda shape, dtype: next(made)))
    for k, v in (("M", m), ("C", c), ("K", taps), ("O", n)):
        monkeypatch.setattr(mod, k, v)
    return np.asarray(getattr(mod, name)())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", CASES)
def test_kernel_arithmetic_equals_plain_and_jax(case, kind, monkeypatch):
    m = CASES[case][0]
    x, w = _inputs(case)
    concat = KINDS[kind]
    got = emu_shifted_dot(x, w, m, concat, check=check_tiles(x, w))
    assert (got != UNSET).all(), "an output the kernel never stores"
    plain = getattr(probes, f"probe_{kind}_plain")(
        torch.from_numpy(x), torch.from_numpy(w), m=m).numpy()
    np.testing.assert_array_equal(got, plain)
    want = _run_jax_probe(monkeypatch, f"probe_{kind}", case, [x, w])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("sms", [32, 64])
def test_wider_chunks_equal_plain(kind, sms):
    """On a card of fewer SMs the chunk stays at 64 or 32 columns: the
    warps then store 2 or 1 of the item's 16 or 8 (m16, n8) blocks."""
    m, c, taps, n = 1000, 48, 9, 64
    rng = np.random.default_rng(11)
    x = rng.integers(-128, 128, size=(m + taps - 1, c)).astype(np.int8)
    w = rng.integers(-128, 128, size=(taps * c, n)).astype(np.int8)
    assert DotArgs(m, c, taps, n, KINDS[kind], sms=sms).chunk == 2048 // sms
    got = emu_shifted_dot(x, w, m, KINDS[kind], check=check_tiles(x, w),
                          sms=sms)
    want = getattr(probes, f"probe_{kind}_plain")(
        torch.from_numpy(x), torch.from_numpy(w), m=m).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("align", [(4, 2, 4), (8, 4, 0)])
@pytest.mark.parametrize("kind", KINDS)
def test_unaligned_pointers_take_the_narrow_paths(kind, align):
    """x not 16-byte aligned (bytes, not bulk copies); w not 16-byte
    aligned (bytes, not cp.async); out 16-byte aligned or not (16-byte or
    single stores)."""
    m, c, taps, n = 70, 32, 5, 96
    x_align, w_align, out_align = align
    rng = np.random.default_rng(3)
    x = rng.integers(-128, 128, size=(m + taps - 1, c)).astype(np.int8)
    w = rng.integers(-128, 128, size=(taps * c, n)).astype(np.int8)
    kw = dict(x_align=x_align, w_align=w_align, out_align=out_align)
    p = DotArgs(m, c, taps, n, KINDS[kind], **kw)
    assert not (p.x_vec or p.w_wide)
    assert p.out_vec == (out_align == 0)
    got = emu_shifted_dot(x, w, m, KINDS[kind], check=check_tiles(x, w),
                          **kw)
    want = getattr(probes, f"probe_{kind}_plain")(
        torch.from_numpy(x), torch.from_numpy(w), m=m).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_grid_and_k_split(case):
    m, c, taps, n, _ = CASES[case]
    for concat in (True, False):
        p = DotArgs(m, c, taps, n, concat)
        assert p.grid == (-(-m // 32), -(-n // p.chunk))
        assert p.grid[0] * p.grid[1] >= SMS or p.chunk == MIN_CHUNK
        seg_steps = p.seg_pad // MMA_K
        covered = []
        for warp in range(DOT_WARPS):
            for seg, s, end in p.warp_runs(warp):
                # a run never straddles a segment: for the concat probe a
                # tap, whose A rows lie one row further down
                assert seg * seg_steps <= s < end <= (seg + 1) * seg_steps
                covered.extend(range(s, end))
        assert covered == list(range(p.nseg * seg_steps))
        sizes = [sum(e - s for _, s, e in p.warp_runs(wp))
                 for wp in range(DOT_WARPS)]
        assert max(sizes) - min(sizes) <= 1
    if case == "jax_inputs":
        # 32 row tiles × 4 chunks of 16 columns: 128 blocks of 8 warps,
        # 2 or 3 k32 steps each
        assert p.chunk == 16 and p.grid == (32, 4)
        assert sizes == [2, 2, 2, 3, 2, 2, 2, 3]
    if case == "n200":
        # chunks of 64 would give 128 blocks, fewer than the SMs: 32
        # columns, the last chunk of 8
        assert p.chunk == 32 and p.grid == (32, 7) and n - 6 * 32 == 8
    if case == "c48_taps9":
        # the scratch probe's K (432 → 448) has no tap boundaries to keep;
        # the concat probe's taps are padded to 64: 18 steps, not 14
        assert DotArgs(m, c, taps, n, False).seg_pad // MMA_K == 14
        assert DotArgs(m, c, taps, n, True).nseg * 2 == 18


def test_concat_a_addresses_are_shifted_rows():
    """Step s of the concat probe (tap i = s // (Cp/32)) loads through
    ldmatrix, from x-tile row ρ + i, exactly the fragments a patch tile
    patch[ρ, i·Cp + ch] = x[row0 + ρ + i, ch] (zero for ch >= C) gives at
    step s: the concatenation is an address."""
    m, c, taps, n = 64, 48, 9, 64
    rng = np.random.default_rng(5)
    x = rng.integers(-128, 128, size=(m + taps - 1, c)).astype(np.int8)
    p = DotArgs(m, c, taps, n, True)
    cp = p.seg_pad
    for row0 in (0, 32):
        smem = rng.integers(-128, 128, size=p.smem).astype(np.int8)
        stage_x_rows(p, smem, 0, x.reshape(-1), row0)
        pitch = padded_pitch(taps * cp)
        patch = rng.integers(-128, 128, size=32 * pitch).astype(np.int8)
        for r in range(32):
            for i in range(taps):
                d = r * pitch + i * cp
                patch[d:d + cp] = 0
                patch[d:d + c] = x[row0 + r + i]
        seg_steps = cp // MMA_K
        for s in range(taps * seg_steps):
            i = s // seg_steps
            for mb in range(2):
                rho = 16 * mb + a_lane_row(LANES)
                a = (rho + i) * p.a_pitch + (s - i * seg_steps) * MMA_K \
                    + a_lane_k(LANES)
                want = rho * pitch + s * MMA_K + a_lane_k(LANES)
                np.testing.assert_array_equal(ldmatrix_x4(smem, a),
                                              ldmatrix_x4(patch, want))


def test_chunk_halves_until_the_grid_fills_the_card():
    assert DotArgs(8192, 64, 9, 64, True).chunk == 64      # 256 row tiles
    assert DotArgs(4224, 64, 9, 64, True).chunk == 64      # 132
    assert DotArgs(4192, 64, 9, 64, True).chunk == 32      # 131
    assert DotArgs(1024, 64, 9, 64, True, sms=32).chunk == 64
    assert DotArgs(37, 20, 3, 13, True).grid == (2, 1)


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("case", ["jax_inputs", "ragged", "c48_taps9",
                                  "n200"])
def test_weight_stores_meet_no_bank_twice(case, sms):
    m, c, taps, n, _ = CASES[case]
    for concat in (True, False):
        p = DotArgs(m, c, taps, n, concat, sms=sms)
        assert p.w_pitch % 32 == 16
        stores, reads = warp_bank_conflicts(p)
        assert stores == 1
        if not concat or c % 32 == 0:
            assert reads == 1


def test_tile_adds_meet_at_most_two_lanes_a_bank():
    g, t = LANES >> 2, LANES & 3
    for mb in range(2):
        for j in range(8):
            for e in range(4):
                words = (16 * mb + 8 * (e >> 1) + g) * TILE_PITCH + 8 * j \
                    + 2 * t + (e & 1)
                assert np.bincount(words % 32).max() == 2


def test_byte_perm_transposes_four_words():
    rng = np.random.default_rng(1)
    blk = rng.integers(0, 256, size=(4, 4)).astype(np.uint8)   # [k][col]
    v = [blk[r].view("<u4")[0] for r in range(4)]
    lo01, lo23 = byte_perm(v[0], v[1], 0x5140), byte_perm(v[2], v[3], 0x5140)
    hi01, hi23 = byte_perm(v[0], v[1], 0x7362), byte_perm(v[2], v[3], 0x7362)
    cols = [byte_perm(lo01, lo23, 0x5410), byte_perm(lo01, lo23, 0x7632),
            byte_perm(hi01, hi23, 0x5410), byte_perm(hi01, hi23, 0x7632)]
    for col, word in enumerate(cols):
        got = np.array([word], "<u4").view(np.uint8)
        np.testing.assert_array_equal(got, blk[:, col])


@pytest.mark.parametrize("concat", [True, False])
def test_smem_bytes_match_the_launcher(concat):
    for c, taps in ((64, 9), (20, 3), (48, 9), (1, 1), (200, 11), (32, 60)):
        p = DotArgs(1024, c, taps, 64, concat)
        assert probes.dot_smem_bytes(c, taps, concat) == p.smem
    # JAX's shape: with the raw tile (576 rows of 80 bytes) both need more
    # than the 48 KB a kernel has without the opt-in
    assert probes.dot_smem_bytes(64, 9, concat) > 48 * 1024


def test_smem_limit_raises_in_the_wrapper():
    """Above the card's 227 KB the wrapper raises before any launch (a
    tensor on the meta device takes the card's path and has no memory)."""
    c = 64
    fit = max(t for t in range(1, 64)
              if probes.dot_smem_bytes(c, t, False) <= MAX_SMEM)
    assert probes.dot_smem_bytes(c, fit + 1, False) > MAX_SMEM
    for fn, concat in ((probes.probe_scratch_lane_store, False),
                       (probes.probe_lane_concat, True)):
        taps = max(t for t in range(1, 64)
                   if probes.dot_smem_bytes(c, t, concat) <= MAX_SMEM) + 1
        x = torch.empty((64 + taps, c), dtype=torch.int8, device="meta")
        w = torch.empty((taps * c, 64), dtype=torch.int8, device="meta")
        with pytest.raises(ValueError, match="shared memory"):
            fn(x, w, m=64)
        # one tap fewer passes the check and reaches the launch, which
        # refuses the meta device
        x, w = x[:-1], w[:-c]
        with pytest.raises(ValueError, match="no kernel for device meta"):
            fn(x, w, m=64)
        # on the CPU the plain version takes any size
        xc = torch.ones((64 + taps, c), dtype=torch.int8)
        wc = torch.ones((taps * c, 8), dtype=torch.int8)
        assert int(fn(xc, wc, m=64)[0, 0]) == taps * c


def test_phase_cuts_find_their_lines():
    """tools/layer_times.py --only probes cuts shifted_dot_kernel after each
    phase at lines of the source: each must be there once."""
    from bnn_pynq_tpu_torch.ops import _build
    from bnn_pynq_tpu_torch.tools import layer_times
    source = (_build.CSRC_DIR / "mosaic_probes.cu").read_text()
    cut = layer_times.phase_source(source)
    for phase in (1, 2, 3):
        assert cut.count(f"if (bnn_phase == {phase})") == 1
    assert "bnn_set_phase" in cut
    with pytest.raises(ValueError, match="no single"):
        layer_times.phase_source(source.replace("    s = end;\n", ""))
