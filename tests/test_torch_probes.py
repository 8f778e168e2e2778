"""The probes' plain versions (P1a, P1b, P2) against Python ints and K1's
plain version, bit for bit, at n = 256 on random and edge inputs.

These plain versions are what the card's kernels are held to, so a wrong
8-bit digit split, Toeplitz matrix or carry pass shows here first. P1b's
kernel layout (its shared-memory maps, fragment table and carry chains) is
held here too, by a bank model and a lane-by-lane emulation of one warp.
"""
import numpy as np
import pytest
import torch

from legosnark_tpu_torch import kernels
from legosnark_tpu_torch.curve import bn254
from legosnark_tpu_torch.fields import cuda_limb
from legosnark_tpu_torch.fields import limb as fl
from legosnark_tpu_torch.probes import mont_variants as mv
from legosnark_tpu_torch.utils.bench import edge_ints

# The plain path runs many small torch ops; idle intra-op threads spin and
# starve the other test processes, so the port's tests use one thread.
torch.set_num_threads(1)

N = 256


def _ints(rng, n, bound):
    return [int.from_bytes(rng.bytes(40), "little") % bound for _ in range(n)]


@pytest.mark.parametrize("spec", [bn254.FR, bn254.FQ], ids=["Fr", "Fq"])
def test_mont_products_equal_k1_and_ints(spec):
    rng = np.random.default_rng(31)
    p = spec.p
    xs = edge_ints(p) + _ints(rng, N - 7, 2 * p)
    ys = edge_ints(p)[::-1] + _ints(rng, N - 7, 2 * p)
    a = fl.tensor(fl.ints_to_limbs(xs), "cpu")
    b = fl.tensor(fl.ints_to_limbs(ys), "cpu")
    k1 = cuda_limb.mont_mul_plain(spec, a, b)
    kernels.reset_launches()
    tc = mv.mont_mul_tc(spec, a, b)           # CPU tensors: plain version
    sos = mv.mont_mul_sos(spec, a, b)
    assert sum(kernels.launches.values()) == 0
    assert torch.equal(tc, mv.mont_mul_tc_plain(spec, a, b))
    assert torch.equal(tc, k1) and torch.equal(sos, k1)
    rinv = pow(spec.R, -1, p)
    for i, v in enumerate(fl.limbs_to_ints(tc)):
        # (ab + Mp)/R with M in [0, R): the exact integer, below 2p
        m = (-xs[i] * ys[i] * pow(p, -1, spec.R)) % spec.R
        assert v == (xs[i] * ys[i] + m * p) // spec.R
        assert v % p == xs[i] * ys[i] * rinv % p and v < 2 * p


def test_toeplitz_tables():
    for spec in (bn254.FR, bn254.FQ):
        T = mv.toeplitz_bytes(spec.p).astype(np.int64)
        ninv = spec.ninv.to_bytes(32, "little")
        pb = spec.p.to_bytes(32, "little")
        assert T.shape == (96, 32)
        assert T[0, 0] == ninv[0] and T[31, 0] == ninv[31] and T[0, 1] == 0
        assert T[32, 0] == pb[0] and T[94, 31] == pb[31] and T[32, 1] == 0
        assert not T[95].any()                  # column 63 of m*p is 0
        # the columns of N @ digits and P @ digits are exact in int32
        assert 32 * 255 * 255 < 2**31


@pytest.mark.parametrize("variant", mv.VARIANTS)
def test_limb_product_plain(variant):
    rng = np.random.default_rng(32)
    full = (1 << 256) - 1
    xs = [0, full, full, 1] + _ints(rng, N - 4, 1 << 256)
    ys = [full, full, 1, 0] + _ints(rng, N - 4, 1 << 256)
    a = fl.tensor(fl.ints_to_limbs(xs), "cpu")
    b = fl.tensor(fl.ints_to_limbs(ys), "cpu")
    out = mv.limb_product(a, b, variant)
    assert out.shape == (16, N) and out.dtype == torch.int32
    assert torch.equal(out, mv.limb_product_plain(a, b, variant))
    lo, hi = fl.limbs_to_ints(out[:8]), fl.limbs_to_ints(out[8:])
    for i in range(N):
        if variant == "floor":
            prods = [((xs[i] >> 32 * k) & fl.MASK) * ((ys[i] >> 32 * k)
                     & fl.MASK) for k in range(8)]
            assert lo[i] == sum((v & fl.MASK) << 32 * k
                                for k, v in enumerate(prods))
            assert hi[i] == sum((v >> 32) << 32 * k
                                for k, v in enumerate(prods))
        else:
            assert lo[i] + (hi[i] << 256) == xs[i] * ys[i]
    with pytest.raises(ValueError):
        mv.limb_product(a, b, "roll")


# ---------------------------------------------------------------------------
# P1b's kernel layout, emulated lane by lane (csrc/mont_tc.cu)
# ---------------------------------------------------------------------------

LANE = np.arange(32)
G, T4 = LANE // 4, LANE % 4


def _scalar_wavefronts(words):
    """Shared-memory wavefronts of one 4-byte access by 32 lanes: the most
    distinct words that fall in one of the 32 banks."""
    words = np.asarray(words)
    return max(len(set(words[words % 32 == b].tolist())) for b in range(32))


def _wide_wavefronts(words, width):
    """Wavefronts of one 8- or 16-byte access by 32 lanes (`words`: each
    lane's first word, aligned to the width): half warps (8 bytes) or
    quarter warps (16 bytes), each one wavefront per distinct access in its
    busiest bank group of `width` bytes."""
    words = np.asarray(words)
    per = width // 4                          # words per access
    assert (words % per == 0).all()
    lanes = 128 // width                      # lanes per phase
    units = words // per
    return sum(max(np.bincount(units[q:q + lanes] % lanes, minlength=lanes))
               for q in range(0, 32, lanes))


@pytest.mark.parametrize("access", ["digit stores", "B reads", "pair stores",
                                    "pair reads"])
def test_p1b_shared_memory_has_no_bank_conflicts(access):
    """Every shared-memory access of the kernel takes the fewest wavefronts
    its width allows: 1 for a 4-byte access (32 distinct banks), 2 for an
    8-byte one and 4 for a 16-byte one (every half or quarter warp on
    distinct banks)."""
    if access == "digit stores":      # a lane's 8 words as two uint4
        for h in range(2):
            first = mv.tc_digit_word(LANE, 4 * h)
            for q in range(4):
                assert (mv.tc_digit_word(LANE, 4 * h + q) == first + q).all()
            assert _wide_wavefronts(first, 16) == 4
    elif access == "B reads":         # words t and 4 + t of element 8j + g
        for j in range(4):
            for h in range(2):
                words = mv.tc_digit_word(8 * j + G, 4 * h + T4)
                assert _scalar_wavefronts(words) == 1
    elif access == "pair stores":     # words 2g, 2g + 1 of 8j + 2t + c
        for j in range(4):
            for c in range(2):
                first = mv.tc_pair_word(8 * j + 2 * T4 + c, 2 * G)
                assert (mv.tc_pair_word(8 * j + 2 * T4 + c, 2 * G + 1)
                        == first + 1).all()
                assert _wide_wavefronts(first, 8) == 2
    else:                             # a lane's pair words 4u.. as one uint4
        for u in range(4):
            first = mv.tc_pair_word(LANE, 4 * u)
            for q in range(4):
                assert (mv.tc_pair_word(LANE, 4 * u + q) == first + q).all()
            assert _wide_wavefronts(first, 16) == 4
    # the maps are one-to-one on a warp's buffers
    assert len({mv.tc_digit_word(e, w) for e in range(32)
                for w in range(8)}) == 256
    assert len({mv.tc_pair_word(e, q) for e in range(32)
                for q in range(16)}) == 512


@pytest.mark.parametrize("spec", [bn254.FR, bn254.FQ], ids=["Fr", "Fq"])
def test_p1b_fragment_table(spec):
    """The fragment table holds N's and P's Toeplitz rows in slot order:
    lane g's rows of the two tiles are one slot group, P's slots s < 30
    are columns 32 + s and slots 30, 31 columns 30, 31."""
    T = mv.toeplitz_bytes(spec.p)
    F = mv.tc_fragments(spec.p)
    assert F.shape == (516,) and F[512] == spec.p.to_bytes(32, "little")[31]
    assert sorted(4 * (r % 8) + 2 * mt + r // 8 for mt in range(2)
                  for r in range(16)) == list(range(32))
    for tile in range(4):
        for lane in range(32):
            g, t = divmod(lane, 4)
            regs = F[128 * tile + 4 * lane:][:4].astype("<u4").view(np.uint8)
            for i, (r, off) in enumerate([(g, 0), (g + 8, 0), (g, 16),
                                          (g + 8, 16)]):
                s = mv.tc_tile_slot(tile % 2, r)
                assert s // 4 == g
                col = s if tile < 2 else (32 + s if s < 30 else s)
                row = T[col if tile < 2 else 32 + col]
                assert (regs[4 * i:4 * i + 4] == row[off + 4 * t:][:4]).all()


def _u8(words):
    """uint32 words [...] -> their bytes [..., 4], byte q at bits 8q."""
    return (np.asarray(words, dtype=np.int64)[..., None]
            >> (8 * np.arange(4))) & 0xFF


def _mma_u8(afrag, b0, b1):
    """mma.sync.m16n8k32.row.col.s32.u8.u8.s32 from the lanes' registers,
    by the PTX fragment definitions: A's a0..a3 hold rows g, g+8, g, g+8
    at bytes 4t.. (a0, a1) and 16+4t.. (a2, a3); B's b0, b1 column g at
    bytes 4t.. and 16+4t..; D's d0..d3 rows g, g, g+8, g+8, columns 2t,
    2t+1. afrag [32, 4], b0, b1 [32] -> d [32, 4] (int64)."""
    A = np.full((16, 32), -1, dtype=np.int64)
    B = np.full((32, 8), -1, dtype=np.int64)
    cols = 4 * T4[:, None] + np.arange(4)
    for r, (row, off) in enumerate([(G, 0), (G + 8, 0), (G, 16), (G + 8, 16)]):
        A[row[:, None], off + cols] = _u8(afrag[:, r])
    B[cols, G[:, None]] = _u8(b0)
    B[16 + cols, G[:, None]] = _u8(b1)
    assert (A >= 0).all() and (B >= 0).all()   # every byte from one lane
    D = A @ B
    return np.stack([D[G, 2 * T4], D[G, 2 * T4 + 1], D[G + 8, 2 * T4],
                     D[G + 8, 2 * T4 + 1]], axis=1)


def _words_of(v, k):
    return [(v >> (32 * i)) & fl.MASK for i in range(k)]


def _p1b_warp(frag, xs, ys):
    """The kernel's data flow for one warp of 32 elements: t = a*b, the
    digit and pair buffers through their maps, the A fragments from the
    fragment table, the mma by fragments, the lanes' carry chains. Returns
    the 32 results as ints."""
    frag = frag.astype(np.int64)

    def contract(digits, tiles):
        dig = np.zeros(256, dtype=np.int64)
        for e in range(32):
            for w in range(8):
                dig[mv.tc_digit_word(e, w)] = digits[e][w]
        pairs = np.full(512, -1, dtype=np.int64)
        af = [frag[128 * tile:][:128].reshape(32, 4) for tile in tiles]
        for j in range(4):
            b0 = dig[mv.tc_digit_word(8 * j + G, T4)]
            b1 = dig[mv.tc_digit_word(8 * j + G, 4 + T4)]
            d0, d1 = _mma_u8(af[0], b0, b1), _mma_u8(af[1], b0, b1)
            for c in range(2):
                w = mv.tc_pair_word(8 * j + 2 * T4 + c, 2 * G)
                pairs[w] = d0[:, c] + (d0[:, 2 + c] << 8)
                pairs[w + 1] = d1[:, c] + (d1[:, 2 + c] << 8)
        assert (pairs >= 0).all()                    # every word written
        # lane e's pair words 4u..4u+3: one 16-byte read
        return [sum((pairs[mv.tc_pair_word(e, 4 * u):][:4].tolist()
                     for u in range(4)), []) for e in range(32)]

    def split(p0, p1):     # `split_group`: p0 + 2^16 p1 = lo + 2^32 hi
        s = p0 + ((p1 << 16) & fl.MASK)
        return s & fl.MASK, (p1 >> 16) + (s >> 32)

    def chain(xs, ys):     # an 8-word add.cc chain: (words, carry out)
        c, out = 0, []
        for x, y in zip(xs, ys):
            c += x + y
            out.append(c & fl.MASK)
            c >>= 32
        return out, c

    tt = [_words_of(x * y, 16) for x, y in zip(xs, ys)]
    ps = contract(tt, (0, 1))
    ms = []
    for e in range(32):
        lo, hi = zip(*(split(ps[e][2 * w], ps[e][2 * w + 1])
                       for w in range(8)))
        ms.append(chain(lo, (0,) + hi[:7])[0])       # mod R
    ps = contract(ms, (2, 3))
    out = []
    for e in range(32):
        p = ps[e]                    # group 7: columns 60, 61 | 30, 31
        c_lo, c_hi = split(0, p[15])
        c_lo += tt[e][7]
        c_hi, c_lo = c_hi + (c_lo >> 32), c_lo & fl.MASK
        carry = c_hi + int(any([c_lo] + tt[e][:7]))
        lo, hi = zip(*([split(p[2 * w], p[2 * w + 1]) for w in range(7)]
                       + [split(p[14], (ms[e][7] >> 24) * int(frag[512]))]))
        r, c1 = chain(tt[e][8:], lo)
        r, c2 = chain(r, (carry,) + hi[:7])
        assert c1 == c2 == hi[7] == 0                # u / R < 2^256
        out.append(sum(v << (32 * i) for i, v in enumerate(r)))
    return out


@pytest.mark.parametrize("spec", [bn254.FR, bn254.FQ], ids=["Fr", "Fq"])
def test_p1b_lane_emulation_equals_plain_and_ints(spec):
    """Two warps of the kernel, emulated: the edge values, the all-ones
    words that fill every digit, and random values in [0, 2p)."""
    rng = np.random.default_rng(33)
    p = spec.p
    top = 2 * p - 1
    xs = edge_ints(p) + [top] * 4 + _ints(rng, 64 - 11, 2 * p)
    ys = edge_ints(p)[::-1] + [top, top - 1, p - 2, 1] + _ints(rng, 64 - 11,
                                                             2 * p)
    frag = mv.tc_fragments(p)
    got = _p1b_warp(frag, xs[:32], ys[:32]) + _p1b_warp(frag, xs[32:], ys[32:])
    a = fl.tensor(fl.ints_to_limbs(xs), "cpu")
    b = fl.tensor(fl.ints_to_limbs(ys), "cpu")
    assert got == list(fl.limbs_to_ints(mv.mont_mul_tc_plain(spec, a, b)))
    ninv = pow(-p, -1, spec.R)
    for x, y, v in zip(xs, ys, got):
        assert v == (x * y + (x * y * ninv % spec.R) * p) // spec.R


def test_p1b_low_half_carry_from_two_columns():
    """The kernel's carry out of u's low half, ceil((t_lo + col_30 2^240 +
    col_31 2^248) / 2^256), equals the exact (t_lo + low) >> 256 whenever
    t_lo + low = 0 mod 2^256, for columns up to their maximum 32 * 255^2,
    all columns at the maximum included."""
    rng = np.random.default_rng(34)
    cmax = 32 * 255 * 255
    R = 1 << 256
    cases = [[cmax] * 32, [0] * 30 + [cmax, cmax], [cmax] * 30 + [0, 0],
             [0] * 32, [1] + [0] * 31]
    cases += [rng.integers(0, cmax + 1, 32).tolist() for _ in range(200)]
    for cols in cases:
        low = sum(c << (8 * k) for k, c in enumerate(cols))
        t_lo = -low % R
        top = (t_lo >> 224) + (cols[30] << 16) + (cols[31] << 24)
        rest = (top & fl.MASK) | (t_lo & ((1 << 224) - 1))
        assert (top >> 32) + (rest != 0) == (t_lo + low) >> 256
