"""Baseline JPEG without an image library: a decoder and an encoder on
numpy that compute what libjpeg(-turbo) computes.

``decode`` reads baseline, extended sequential and progressive Huffman
files (SOF0 / SOF1 / SOF2, 8-bit samples): Huffman tables from the file,
restart intervals, gray or YCbCr with any sampling factors (4:4:4, 4:2:2
and 4:2:0 take libjpeg's "fancy" triangle upsampling, as its
decompressor does by default, other factors box replication).  A
progressive file's scans (jdphuff.c: DC first and refinement scans,
interleaved or not; AC first scans over a spectral band with end-of-band
runs; AC refinement scans with their correction bits) build the same
coefficients as the sequential decoder.  The inverse DCT is libjpeg's
ISLOW integer transform (jidctint.c) and the colour conversion its
fixed-point tables (jdcolor.c), so a file decodes to the bytes PIL (which
bundles libjpeg-turbo) returns.  Lossless, arithmetic-coded and
hierarchical files, 12-bit samples, and a progressive file that leaves
its low coefficients unrefined (which libjpeg would block-smooth) raise a
``ValueError``.

``encode`` writes what ``PIL.Image.save(format="JPEG", quality=q)``
writes for an RGB image: the JFIF header, libjpeg's standard quantisation
tables scaled by quality (``jpeg_quality_scaling``), RGB -> YCbCr in its
fixed point (jccolor.c), 2x2 chroma downsampling with its alternating
rounding bias (jcsample.c; or none, 4:4:4), its edge padding and dummy
blocks
(jcprepct.c, jccoefct.c), the ISLOW forward DCT (jfdctint.c), rounding
quantisation, and the standard Huffman tables of the JPEG standard's
Annex K.  Every stage is vectorised over all blocks and symbols; the
only Python loops of the codec are the decoder's symbol loops (a Huffman
stream is sequential).
"""

from __future__ import annotations

import numpy as np

# zigzag position -> natural (row-major) index within an 8x8 block
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int64)

# the JPEG standard's example tables (Annex K.1), natural order
STD_LUMA_QT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103,
    99], np.int64)
STD_CHROMA_QT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32, np.int64)

# Annex K.3 Huffman tables: (code counts by length 1..16, symbols)
_AC_LUMA_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_CHROMA_VALS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a82838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")
STD_HUFFMAN = {
    ("dc", 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
                bytes(range(12))),
    ("ac", 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d),
                _AC_LUMA_VALS),
    ("dc", 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
                bytes(range(12))),
    ("ac", 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
                _AC_CHROMA_VALS),
}

# libjpeg's fixed-point constants (CONST_BITS 13) and colour tables
# (SCALEBITS 16)
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172

# the encoder's chroma subsampling (PIL's subsampling 2, its default,
# and 0) -> the luma component's (h, v) sampling factors
SUBSAMPLING = {"4:2:0": (2, 2), "4:4:4": (1, 1)}


def _fix16(x: float) -> int:
    return int(x * 65536 + 0.5)


def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def idct_islow(coef: np.ndarray) -> np.ndarray:
    """libjpeg's ISLOW inverse DCT (jidctint.c) of dequantised blocks
    [n, 8, 8] (natural order, int64) -> samples [n, 8, 8] uint8, with its
    range limit (the output wraps modulo 1024 before the clamp, as its
    table does)."""
    def butterfly(x, axis, shift):
        g = [np.take(x, k, axis=axis) for k in range(8)]
        z2, z3 = g[2], g[6]
        z1 = (z2 + z3) * FIX_0_541196100
        tmp2 = z1 - z3 * FIX_1_847759065
        tmp3 = z1 + z2 * FIX_0_765366865
        tmp0 = (g[0] + g[4]) << CONST_BITS
        tmp1 = (g[0] - g[4]) << CONST_BITS
        tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
        tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
        t0, t1, t2, t3 = g[7], g[5], g[3], g[1]
        z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
        z5 = (z3 + z4) * FIX_1_175875602
        t0 = t0 * FIX_0_298631336
        t1 = t1 * FIX_2_053119869
        t2 = t2 * FIX_3_072711026
        t3 = t3 * FIX_1_501321110
        z1 = z1 * -FIX_0_899976223
        z2 = z2 * -FIX_2_562915447
        z3 = z3 * -FIX_1_961570560 + z5
        z4 = z4 * -FIX_0_390180644 + z5
        t0 += z1 + z3
        t1 += z2 + z4
        t2 += z2 + z3
        t3 += z1 + z4
        out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
               tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
        return np.stack([_descale(o, shift) for o in out], axis=axis)

    ws = butterfly(coef, 1, CONST_BITS - PASS1_BITS)       # columns
    out = butterfly(ws, 2, CONST_BITS + PASS1_BITS + 3)    # rows
    out = ((out + 512) & 1023) - 512
    return np.clip(out + 128, 0, 255).astype(np.uint8)


def fdct_islow(x: np.ndarray) -> np.ndarray:
    """libjpeg's ISLOW forward DCT (jfdctint.c) of centred 8-bit samples
    [n, 8, 8] (int32: for such samples no intermediate leaves 32 bits)
    -> coefficients [n, 8, 8] (natural order, scaled up by 8 as
    libjpeg's are)."""
    def butterfly(x, axis, even_shift, odd_shift, even_left):
        d = [np.take(x, k, axis=axis) for k in range(8)]
        tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
        tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
        tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
        tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
        tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
        tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
        if even_left:
            o0 = (tmp10 + tmp11) << PASS1_BITS
            o4 = (tmp10 - tmp11) << PASS1_BITS
        else:
            o0 = _descale(tmp10 + tmp11, PASS1_BITS)
            o4 = _descale(tmp10 - tmp11, PASS1_BITS)
        z1 = (tmp12 + tmp13) * FIX_0_541196100
        o2 = _descale(z1 + tmp13 * FIX_0_765366865, even_shift)
        o6 = _descale(z1 - tmp12 * FIX_1_847759065, even_shift)
        z1, z2 = tmp4 + tmp7, tmp5 + tmp6
        z3, z4 = tmp4 + tmp6, tmp5 + tmp7
        z5 = (z3 + z4) * FIX_1_175875602
        tmp4 = tmp4 * FIX_0_298631336
        tmp5 = tmp5 * FIX_2_053119869
        tmp6 = tmp6 * FIX_3_072711026
        tmp7 = tmp7 * FIX_1_501321110
        z1 = z1 * -FIX_0_899976223
        z2 = z2 * -FIX_2_562915447
        z3 = z3 * -FIX_1_961570560 + z5
        z4 = z4 * -FIX_0_390180644 + z5
        o7 = _descale(tmp4 + z1 + z3, odd_shift)
        o5 = _descale(tmp5 + z2 + z4, odd_shift)
        o3 = _descale(tmp6 + z2 + z3, odd_shift)
        o1 = _descale(tmp7 + z1 + z4, odd_shift)
        return np.stack([o0, o1, o2, o3, o4, o5, o6, o7], axis=axis)

    rows = butterfly(x, 2, CONST_BITS - PASS1_BITS, CONST_BITS - PASS1_BITS,
                     True)
    return butterfly(rows, 1, CONST_BITS + PASS1_BITS,
                     CONST_BITS + PASS1_BITS, False)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert: [H, W] uint8 planes -> [H, W, 3]."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    cr_r = (_fix16(1.40200) * x + half) >> 16
    cb_b = (_fix16(1.77200) * x + half) >> 16
    cr_g = -_fix16(0.71414) * x
    cb_g = -_fix16(0.34414) * x + half
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _rgb_to_ycc(rgb: np.ndarray):
    """jccolor.c's rgb_ycc_convert: [H, W, 3] uint8 -> three [H, W] int32
    planes (every sum fits 32 bits, as in libjpeg)."""
    r, g, b = (rgb[..., k].astype(np.int32) for k in range(3))
    half, off = 1 << 15, 128 << 16
    y = (_fix16(0.29900) * r + _fix16(0.58700) * g + _fix16(0.11400) * b
         + half) >> 16
    cb = (-_fix16(0.16874) * r - _fix16(0.33126) * g + _fix16(0.5) * b
          + off + half - 1) >> 16
    cr = (_fix16(0.5) * r - _fix16(0.41869) * g - _fix16(0.08131) * b
          + off + half - 1) >> 16
    return y, cb, cr


def _upsample(plane: np.ndarray, dh: int, dw: int, fh: int, fv: int,
              H: int, W: int) -> np.ndarray:
    """libjpeg's upsampling of a decoded component (jdsample.c): its real
    [dh, dw] samples of the block plane ``plane`` to [H, W].  2x1, 2x2
    and 1x2 take the fancy (triangle) filter -- the 2h ones only when the
    component is wider than 2 samples, as libjpeg decides -- with rows
    beyond the edges replicated; other factors replicate samples."""
    x = plane[:dh, :dw].astype(np.int32)
    if fh == 1 and fv == 1:
        return plane[:H, :W]
    fancy_h = fh == 2 and dw > 2
    if (fh, fv) == (2, 2) and fancy_h:
        above = np.concatenate([x[:1], x[:-1]], 0)
        below = np.concatenate([x[1:], x[-1:]], 0)
        rows = []
        for nb in (above, below):
            s = 3 * x + nb                           # column sums
            left = np.concatenate([s[:, :1], s[:, :-1]], 1)
            right = np.concatenate([s[:, 1:], s[:, -1:]], 1)
            even = (3 * s + left + 8) >> 4
            odd = (3 * s + right + 7) >> 4
            even[:, 0] = (4 * s[:, 0] + 8) >> 4
            odd[:, -1] = (4 * s[:, -1] + 7) >> 4
            rows.append(np.stack([even, odd], -1).reshape(dh, 2 * dw))
        out = np.stack(rows, 1).reshape(2 * dh, 2 * dw)
    elif (fh, fv) == (2, 1) and fancy_h:
        left = np.concatenate([x[:, :1], x[:, :-1]], 1)
        right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
        even = (3 * x + left + 1) >> 2
        odd = (3 * x + right + 2) >> 2
        even[:, 0] = x[:, 0]
        odd[:, -1] = x[:, -1]
        out = np.stack([even, odd], -1).reshape(dh, 2 * dw)
    elif (fh, fv) == (1, 2):
        above = np.concatenate([x[:1], x[:-1]], 0)
        below = np.concatenate([x[1:], x[-1:]], 0)
        out = np.stack([(3 * x + above + 1) >> 2, (3 * x + below + 2) >> 2],
                       1).reshape(2 * dh, dw)
    else:
        out = np.repeat(np.repeat(x, fv, 0), fh, 1)
    return out[:H, :W].astype(np.uint8)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def _huffman_lut(bits, vals) -> list:
    """A 65,536-entry table of the next 16 bits -> (symbol << 5 | code
    length); 0 where no code matches."""
    lut = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (vals[k] << 5) | length
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _windows(data: bytes) -> list:
    """The 16 bits starting at every bit of ``data`` (zeros past its
    end, as libjpeg fills a truncated stream)."""
    b = np.frombuffer(data + b"\0\0\0\0", np.uint8).astype(np.int64)
    t = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
    w = (t[:, None] >> (8 - np.arange(8))[None, :]) & 0xFFFF
    return w.reshape(-1).tolist()


def _decode_interval(W, blocks, preds, idx, val, where: str):
    """Decode one restart interval's blocks [(coefficient base, component
    slot, DC table, AC table)], appending (index, value) pairs."""
    nat = _NATURAL_LIST
    pos = 0
    for base, ci, dcl, acl in blocks:
        e = dcl[W[pos]]
        if not e:
            raise ValueError(f"{where}: corrupt JPEG data (bad DC code)")
        pos += e & 31
        n = e >> 5
        if n:
            v = W[pos] >> (16 - n)
            pos += n
            if v < (1 << (n - 1)):
                v -= (1 << n) - 1
            preds[ci] += v
        idx.append(base)
        val.append(preds[ci])
        k = 1
        while k < 64:
            e = acl[W[pos]]
            if not e:
                raise ValueError(f"{where}: corrupt JPEG data (bad AC code)")
            pos += e & 31
            rs = e >> 5
            n = rs & 15
            if not n:
                if rs != 0xF0:
                    break                       # end of block
                k += 16
                continue
            k += rs >> 4
            if k > 63:
                raise ValueError(f"{where}: corrupt JPEG data (AC index)")
            v = W[pos] >> (16 - n)
            pos += n
            if v < (1 << (n - 1)):
                v -= (1 << n) - 1
            idx.append(base + nat[k])
            val.append(v)
            k += 1


_NATURAL_LIST = NATURAL.tolist()


def _segments(data: bytes, start: int):
    """The entropy-coded data from ``start``: (its restart intervals
    with the 0xFF00 stuffing removed, the offset of the marker that ends
    it)."""
    arr = np.frombuffer(data, np.uint8)
    ff = np.nonzero(arr[start:-1] == 0xFF)[0] + start
    nxt = arr[ff + 1]
    end, cuts = len(data), []
    for p, m in zip(ff.tolist(), nxt.tolist()):
        if m == 0x00 or m == 0xFF:
            continue
        if 0xD0 <= m <= 0xD7:
            cuts.append(p)
            continue
        end = p
        break
    pieces, s = [], start
    for p in cuts:
        if p >= end:
            break
        pieces.append(data[s:p])
        s = p + 2
    pieces.append(data[s:end])
    return [p.replace(b"\xff\x00", b"\xff") for p in pieces], end


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A baseline, extended sequential or progressive Huffman JPEG ->
    uint8 [H, W] (gray) or [H, W, 3] (RGB), as libjpeg decodes it with
    its defaults (ISLOW, fancy upsampling).  ``name`` names the file in
    errors."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file (no SOI marker)")
    qts, huff, comps, frame = {}, {}, [], None
    restart, adobe, pos = 0, None, 2
    coef, progressive = None, False
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"{name}: corrupt JPEG (no marker at {pos})")
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker == 0xD9:                        # EOI
            break
        seg_len = int.from_bytes(data[pos + 2:pos + 4], "big")
        seg = data[pos + 4:pos + 2 + seg_len]
        pos += 2 + seg_len
        if marker in (0xC0, 0xC1, 0xC2):          # SOF0 / SOF1 / SOF2
            if seg[0] != 8:
                raise ValueError(f"{name}: {seg[0]}-bit JPEG samples are "
                                 f"not read (8-bit only; ROADMAP Queue 1, "
                                 f"item 11.7)")
            H = int.from_bytes(seg[1:3], "big")
            W = int.from_bytes(seg[3:5], "big")
            nc = seg[5]
            for k in range(nc):
                cid, hv, tq = seg[6 + 3 * k:9 + 3 * k]
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 15,
                              "tq": tq})
            frame = (H, W)
            coef = _alloc_coefficients(comps, H, W)
            progressive = marker == 0xC2
            if progressive:
                # the coefficients as a list, refined scan by scan, and
                # per component the Al each coefficient was last read at
                # (-1: not yet), as libjpeg's coef_bits
                coef["list"] = [0] * coef["flat"].size
                coef["bits"] = [[-1] * 64 for _ in comps]
        elif 0xC3 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            kind = "lossless" if marker in (0xC3, 0xC7, 0xCB, 0xCF) else \
                "arithmetic-coded" if marker >= 0xC9 else "hierarchical"
            raise ValueError(
                f"{name}: {kind} JPEG (SOF{marker - 0xC0}) is not read; "
                f"only baseline, extended sequential and progressive "
                f"Huffman JPEG is (ROADMAP Queue 1, item 11.7)")
        elif marker == 0xCC:
            raise ValueError(f"{name}: arithmetic-coded JPEG is not read "
                             f"(ROADMAP Queue 1, item 11.7)")
        elif marker == 0xDB:                      # DQT
            k = 0
            while k < len(seg):
                pq, tq = seg[k] >> 4, seg[k] & 15
                n = 128 if pq else 64
                raw = np.frombuffer(seg[k + 1:k + 1 + n],
                                    ">u2" if pq else np.uint8)
                qt = np.zeros(64, np.int64)
                qt[NATURAL] = raw.astype(np.int64)
                qts[tq] = qt
                k += 1 + n
        elif marker == 0xC4:                      # DHT
            k = 0
            while k < len(seg):
                tc, th = seg[k] >> 4, seg[k] & 15
                bits = list(seg[k + 1:k + 17])
                n = sum(bits)
                vals = seg[k + 17:k + 17 + n]
                huff[("ac" if tc else "dc", th)] = _huffman_lut(bits, vals)
                k += 17 + n
        elif marker == 0xDD:                      # DRI
            restart = int.from_bytes(seg[:2], "big")
        elif marker == 0xEE and seg[:5] == b"Adobe":
            adobe = seg[11] if len(seg) > 11 else None
        elif marker == 0xDA:                      # SOS
            if frame is None:
                raise ValueError(f"{name}: scan before the frame header")
            ns = seg[0]
            scan = []
            for k in range(ns):
                cid, t = seg[1 + 2 * k], seg[2 + 2 * k]
                ci = next(i for i, c in enumerate(comps) if c["id"] == cid)
                scan.append((ci, huff.get(("dc", t >> 4)),
                             huff.get(("ac", t & 15))))
            ss, se = seg[1 + 2 * ns], seg[2 + 2 * ns]
            ah, al = seg[3 + 2 * ns] >> 4, seg[3 + 2 * ns] & 15
            pieces, pos = _segments(data, pos)
            if progressive:
                _decode_progressive_scan(pieces, scan, comps, coef, restart,
                                         (ss, se, ah, al), name)
            else:
                _decode_scan(pieces, scan, comps, coef, restart, name)
        # APPn, COM and anything else: skipped
    if frame is None:
        raise ValueError(f"{name}: no frame header")
    if progressive:
        _check_refined(coef["bits"], name)
        coef["flat"] = np.asarray(coef.pop("list"), np.int64)
    return _reconstruct(coef, comps, qts, frame, adobe, name)


def _alloc_coefficients(comps, H, W):
    """Per component its block plane (rows, cols of blocks, padded to
    whole MCUs) and one flat coefficient array for all of them."""
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    off = 0
    for c in comps:
        c["nby"], c["nbx"] = mcuy * c["v"], mcux * c["h"]
        c["dh"] = -(-H * c["v"] // vmax)
        c["dw"] = -(-W * c["h"] // hmax)
        c["off"] = off
        off += c["nby"] * c["nbx"] * 64
    return {"flat": np.zeros(off, np.int64), "mcu": (mcuy, mcux),
            "max": (vmax, hmax)}


def _scan_blocks(scan, comps, coef):
    """The blocks of one scan in stream order: (coefficient base of each,
    its component's slot in the scan, blocks per MCU).  A scan of one
    component covers that component's own blocks, one an MCU; an
    interleaved scan walks the MCUs, padding blocks included."""
    if len(scan) == 1:                          # non-interleaved
        c = comps[scan[0][0]]
        by, bx = np.meshgrid(np.arange(-(-c["dh"] // 8)),
                             np.arange(-(-c["dw"] // 8)), indexing="ij")
        bases = c["off"] + (by * c["nbx"] + bx).reshape(-1) * 64
        return bases.tolist(), [0] * bases.size, 1
    mcuy, mcux = coef["mcu"]
    parts, slot_parts = [], []
    for s, (ci, _, _) in enumerate(scan):
        c = comps[ci]
        my, mx, v, h = np.meshgrid(np.arange(mcuy), np.arange(mcux),
                                   np.arange(c["v"]), np.arange(c["h"]),
                                   indexing="ij")
        b = c["off"] + ((my * c["v"] + v) * c["nbx"] + mx * c["h"] + h) * 64
        parts.append(b.reshape(mcuy * mcux, -1))
        slot_parts.append(np.full(parts[-1].shape, s))
    bases = np.concatenate(parts, 1).reshape(-1)
    slots = np.concatenate(slot_parts, 1).reshape(-1)
    per_mcu = sum(comps[ci]["v"] * comps[ci]["h"] for ci, _, _ in scan)
    return bases.tolist(), slots.tolist(), per_mcu


def _intervals(pieces, n_blocks: int, restart: int, per_mcu: int, name):
    """(restart interval's window list, its first block, its end block)
    for the blocks of one scan."""
    step = restart * per_mcu if restart else n_blocks
    for k, start in enumerate(range(0, n_blocks, step)):
        if k >= len(pieces):
            raise ValueError(f"{name}: corrupt JPEG (missing restart "
                             f"interval {k})")
        yield _windows(pieces[k]), start, min(start + step, n_blocks)


def _decode_scan(pieces, scan, comps, coef, restart, name):
    """The blocks of one sequential scan in stream order, cut into restart
    intervals, decoded into ``coef``."""
    for _, dcl, acl in scan:
        if dcl is None or acl is None:
            raise ValueError(f"{name}: a scan uses an undefined Huffman "
                             f"table")
    bases, slots, per_mcu = _scan_blocks(scan, comps, coef)
    tables = [(dcl, acl) for _, dcl, acl in scan]
    blocks = [(b, s, *tables[s]) for b, s in zip(bases, slots)]
    idx, val = [], []
    for W, a, b in _intervals(pieces, len(blocks), restart, per_mcu, name):
        _decode_interval(W, blocks[a:b], [0] * len(scan), idx, val, name)
    coef["flat"][np.asarray(idx, np.int64)] = np.asarray(val, np.int64)


# ---------------------------------------------------------------------------
# progressive scans (jdphuff.c)
# ---------------------------------------------------------------------------

def _decode_progressive_scan(pieces, scan, comps, coef, restart, band, name):
    """One scan of a progressive file: the band ``(Ss, Se, Ah, Al)`` of
    its components' coefficients read into ``coef["list"]``, restart
    interval by restart interval (each starts its DC predictions and its
    end-of-band run at 0)."""
    ss, se, ah, al = band
    # the scan parameters libjpeg refuses (jdphuff.c start_pass_phuff_
    # decoder); a refinement out of sequence is only a warning there
    if (ss == 0 and se != 0 or ss > se or se > 63
            or (ss and len(scan) != 1) or (ah and al != ah - 1) or al > 13):
        raise ValueError(f"{name}: invalid progressive scan (Ss {ss}, Se "
                         f"{se}, Ah {ah}, Al {al}, {len(scan)} components)")
    for ci, dcl, acl in scan:
        coef["bits"][ci][ss:se + 1] = [al] * (se + 1 - ss)
        # every scan but a DC refinement reads Huffman symbols
        if (ss or not ah) and (acl if ss else dcl) is None:
            raise ValueError(f"{name}: a scan uses an undefined Huffman "
                             f"table")
    bases, slots, per_mcu = _scan_blocks(scan, comps, coef)
    C = coef["list"]
    for W, a, b in _intervals(pieces, len(bases), restart, per_mcu, name):
        if ss == 0 and ah == 0:
            luts = [dcl for _, dcl, _ in scan]
            _dc_first(W, bases[a:b], slots[a:b], luts, C, al, name)
        elif ss == 0:
            _dc_refine(W, bases[a:b], C, al)
        elif ah == 0:
            _ac_first(W, bases[a:b], scan[0][2], C, ss, se, al, name)
        else:
            _ac_refine(W, bases[a:b], scan[0][2], C, ss, se, al, name)


def _dc_first(W, bases, slots, luts, C, al, name):
    """DC first scan: each block's DC difference, added to its
    component's prediction, shifted up by Al."""
    preds = [0] * len(luts)
    pos = 0
    for base, s in zip(bases, slots):
        e = luts[s][W[pos]]
        if not e:
            raise ValueError(f"{name}: corrupt JPEG data (bad DC code)")
        pos += e & 31
        n = e >> 5
        if n:
            v = W[pos] >> (16 - n)
            pos += n
            if v < (1 << (n - 1)):
                v -= (1 << n) - 1
            preds[s] += v
        C[base] = preds[s] << al


def _dc_refine(W, bases, C, al):
    """DC refinement scan: one raw bit a block, or'ed in at Al."""
    p1 = 1 << al
    for j, base in enumerate(bases):
        if W[j] >> 15:
            C[base] |= p1


def _ac_first(W, bases, lut, C, ss, se, al, name):
    """AC first scan of one component over the band ``ss..se``: run /
    size symbols, and end-of-band runs that skip whole blocks."""
    nat = _NATURAL_LIST
    pos = eobrun = 0
    for base in bases:
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            e = lut[W[pos]]
            if not e:
                raise ValueError(f"{name}: corrupt JPEG data (bad AC code)")
            pos += e & 31
            rs = e >> 5
            r, n = rs >> 4, rs & 15
            if n:
                k += r
                if k > se:
                    raise ValueError(f"{name}: corrupt JPEG data (AC "
                                     f"index)")
                v = W[pos] >> (16 - n)
                pos += n
                if v < (1 << (n - 1)):
                    v -= (1 << n) - 1
                C[base + nat[k]] = v << al
                k += 1
            elif r == 15:
                k += 16
            else:
                eobrun = 1 << r
                if r:
                    eobrun += W[pos] >> (16 - r)
                    pos += r
                eobrun -= 1
                break


def _ac_refine(W, bases, lut, C, ss, se, al, name):
    """AC refinement scan of one component over ``ss..se``: a correction
    bit for every coefficient already nonzero that the walk passes, and
    new coefficients of +-2^Al placed after runs of still-zero ones."""
    nat = _NATURAL_LIST
    p1, m1 = 1 << al, -1 << al
    pos = eobrun = 0
    for base in bases:
        k = ss
        if not eobrun:
            while k <= se:
                e = lut[W[pos]]
                if not e:
                    raise ValueError(f"{name}: corrupt JPEG data (bad AC "
                                     f"code)")
                pos += e & 31
                rs = e >> 5
                r, n = rs >> 4, rs & 15
                if n:
                    n = p1 if W[pos] >> 15 else m1
                    pos += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += W[pos] >> (16 - r)
                        pos += r
                    break
                # pass r still-zero coefficients (refining the nonzero
                # ones on the way) and stop at the next zero one
                while k <= se:
                    i = base + nat[k]
                    c = C[i]
                    if c:
                        if W[pos] >> 15 and not c & p1:
                            C[i] = c + p1 if c >= 0 else c + m1
                        pos += 1
                    elif r:
                        r -= 1
                    else:
                        break
                    k += 1
                if n:
                    if k > se:
                        raise ValueError(f"{name}: corrupt JPEG data (AC "
                                         f"index)")
                    C[base + nat[k]] = n
                k += 1
        if eobrun:
            # the rest of the band: correction bits only
            while k <= se:
                i = base + nat[k]
                c = C[i]
                if c:
                    if W[pos] >> 15 and not c & p1:
                        C[i] = c + p1 if c >= 0 else c + m1
                    pos += 1
                k += 1
            eobrun -= 1


def _check_refined(bits, name):
    """libjpeg block-smooths a progressive image whose DC or first nine AC
    coefficients (zigzag order) are not read to full precision (jdcoefct.c
    ``smoothing_ok``); that estimate is not ported, so such a file
    raises."""
    for ci, b in enumerate(bits):
        if any(x != 0 for x in b[:10]):
            raise ValueError(
                f"{name}: progressive JPEG leaves component {ci}'s low "
                f"coefficients unrefined (Al {b[:10]}), which libjpeg "
                f"block-smooths; not read (ROADMAP Queue 1, item 11.7)")


def _reconstruct(coef, comps, qts, frame, adobe, name):
    """Dequantise, inverse DCT, upsample and convert the colours."""
    H, W = frame
    vmax, hmax = coef["max"]
    planes = []
    for c in comps:
        n = c["nby"] * c["nbx"]
        blk = coef["flat"][c["off"]:c["off"] + n * 64].reshape(n, 64)
        blk = (blk * qts[c["tq"]]).reshape(n, 8, 8)
        px = idct_islow(blk).reshape(c["nby"], c["nbx"], 8, 8)
        plane = px.transpose(0, 2, 1, 3).reshape(c["nby"] * 8,
                                                 c["nbx"] * 8)
        planes.append(_upsample(plane, c["dh"], c["dw"], hmax // c["h"],
                                vmax // c["v"], H, W))
    if len(comps) == 1:
        return planes[0]
    if len(comps) != 3:
        raise ValueError(f"{name}: {len(comps)}-component JPEG is not read "
                         f"(gray or YCbCr only)")
    if adobe == 0:                              # Adobe: stored as RGB
        return np.stack(planes, -1)
    return _ycc_to_rgb(*planes)


def read_jpeg(path: str) -> np.ndarray:
    """``decode`` of the file at ``path``."""
    with open(path, "rb") as f:
        return decode(f.read(), name=path)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def quality_tables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """libjpeg's jpeg_set_quality(quality, force_baseline=TRUE): the
    standard luma and chroma tables (natural order) scaled."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q

    def scaled(t):
        return np.clip((t * scale + 50) // 100, 1, 255)

    return scaled(STD_LUMA_QT), scaled(STD_CHROMA_QT)


def _edge_pad(x: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Replicate the last row and column of [h, w] out to [rows, cols]."""
    return np.pad(x, ((0, rows - x.shape[0]), (0, cols - x.shape[1])),
                  mode="edge")


def _downsample(x: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """jcsample.c's h2v2 downsampling of a full-size plane padded to
    [2 rows, 2 cols]: the mean of each 2x2 with libjpeg's alternating
    rounding bias (1, 2, 1, ...)."""
    s = _edge_pad(x, 2 * rows, 2 * cols).reshape(rows, 2, cols, 2).sum(
        axis=(1, 3))
    return (s + np.where(np.arange(cols) % 2 == 0, 1, 2)) >> 2


def _blocks(plane: np.ndarray, nby: int, nbx: int) -> np.ndarray:
    return plane.reshape(nby, 8, nbx, 8).transpose(0, 2, 1, 3)


def _quantise(dct: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """Rounding division of the (8x scaled) coefficients by q * 8, half
    away from zero, as libjpeg's quantiser computes it."""
    d = (qt * 8).reshape(8, 8)
    mag = (np.abs(dct) + (d >> 1)) // d
    return np.where(dct < 0, -mag, mag)


def _component_coefficients(plane, qt, h, v, hmax, vmax, H, W):
    """Quantised blocks [mcuy * v, mcux * h, 64] (natural order) of one
    component, with jccoefct.c's dummy blocks past the component's own
    blocks (zero AC, the DC of the block before them in the MCU)."""
    mcux, mcuy = _cdiv(W, 8 * hmax), _cdiv(H, 8 * vmax)
    nbx = _cdiv(_cdiv(W * h, hmax), 8)
    nby = _cdiv(_cdiv(H * v, vmax), 8)
    px = _edge_pad(plane, nby * 8, nbx * 8) - 128
    q = _quantise(fdct_islow(_blocks(px, nby, nbx).reshape(-1, 8, 8)), qt)
    q = q.reshape(nby, nbx, 64)
    full = np.zeros((mcuy * v, mcux * h, 64), np.int32)
    full[:nby, :nbx] = q
    if nbx < mcux * h:             # right edge: the last real block's DC
        full[:nby, nbx:, 0] = q[:, -1:, 0]
    if nby < mcuy * v:             # bottom rows: the MCU row's last DC
        last = full[nby - 1].reshape(mcux, h, 64)[:, -1, 0]
        full[nby:, :, 0] = np.repeat(last, h)[None, :]
    return full


def _tokens(coef: np.ndarray, comp_of: np.ndarray, table_of: np.ndarray,
            tables: list):
    """The Huffman code words of the blocks ``coef`` [n, 64] (natural
    order, in stream order; block b of component ``comp_of[b]``, coded
    with the table pair ``table_of[b]``): their (values, bit lengths),
    each code followed by its extra bits."""
    n = coef.shape[0]
    zz = coef[:, NATURAL]                                # [n, 64] zigzag
    # DC differences per component in stream order
    dc = zz[:, 0]
    diff = np.empty_like(dc)
    for c in np.unique(comp_of):
        sel = np.nonzero(comp_of == c)[0]
        d = dc[sel]
        diff[sel] = d - np.concatenate([[0], d[:-1]])
    # AC: the non-zero coefficients, their runs, ZRLs and the EOBs
    blk, pos = np.nonzero(zz[:, 1:])
    pos = pos + 1
    acv = zz[blk, pos]
    first = np.ones(blk.size, bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.where(first, 0, np.concatenate([[0], pos[:-1]]))
    run = pos - prev - 1
    nzrl = run // 16
    last = np.zeros(n, np.int64)                         # last AC index
    last[blk] = pos
    eob = np.nonzero(last < 63)[0]

    def magnitude(v):
        a = np.abs(v)
        size = np.zeros(a.shape, np.int64)
        m = a.copy()
        while np.any(m):                                 # <= 11 rounds
            size += m > 0
            m >>= 1
        bits = np.where(v < 0, v + (1 << size) - 1, v)
        return size, bits

    dsize, dbits = magnitude(diff)
    asize, abits = magnitude(acv)
    # one entry per code word: (block, key within block, table slot)
    zrl_blk = np.repeat(blk, nzrl)
    zrl_key = np.repeat(2 * pos, nzrl)
    blocks = np.concatenate([np.arange(n), zrl_blk, blk, eob])
    keys = np.concatenate([np.zeros(n, np.int64), zrl_key, 2 * pos + 1,
                           np.full(eob.size, 200)])
    symbols = np.concatenate([dsize, np.full(zrl_blk.size, 0xF0),
                              (run % 16) * 16 + asize,
                              np.zeros(eob.size, np.int64)])
    is_ac = np.concatenate([np.zeros(n, bool),
                            np.ones(zrl_blk.size + blk.size + eob.size,
                                    bool)])
    xsize = np.concatenate([dsize, np.zeros(zrl_blk.size, np.int64), asize,
                            np.zeros(eob.size, np.int64)])
    xbits = np.concatenate([dbits, np.zeros(zrl_blk.size, np.int64), abits,
                            np.zeros(eob.size, np.int64)])
    srt = np.lexsort((keys, blocks))
    blocks, symbols, is_ac = blocks[srt], symbols[srt], is_ac[srt]
    xsize, xbits = xsize[srt], xbits[srt]
    slot = table_of[blocks] * 2 + is_ac
    code = np.zeros(symbols.size, np.int64)
    clen = np.zeros(symbols.size, np.int64)
    for s, (codes, lens) in enumerate(tables):
        sel = slot == s
        code[sel] = codes[symbols[sel]]
        clen[sel] = lens[symbols[sel]]
    values = np.stack([code, xbits], 1).reshape(-1)
    lengths = np.stack([clen, xsize], 1).reshape(-1)
    return values, lengths


def _code_table(bits, vals):
    """Canonical (codes[256], lengths[256]) of a DHT table."""
    codes = np.zeros(256, np.int64)
    lens = np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = code
            lens[vals[k]] = length
            code += 1
            k += 1
        code <<= 1
    return codes, lens


def _pack_bits(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Concatenate the code words MSB first, pad the last byte with ones
    and stuff a zero byte after every 0xFF."""
    keep = lengths > 0
    values, lengths = values[keep], lengths[keep]
    total = int(lengths.sum())
    owner = np.repeat(np.arange(lengths.size), lengths)
    start = np.cumsum(lengths) - lengths
    k = np.arange(total) - start[owner]
    bits = (values[owner] >> (lengths[owner] - 1 - k)) & 1
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.int64)]).astype(np.uint8)
    out = np.packbits(bits)
    ff = np.nonzero(out == 0xFF)[0]
    if ff.size:
        out = np.insert(out, ff + 1, 0)
    return out.tobytes()


def _marker(code: int, payload: bytes) -> bytes:
    return bytes([0xFF, code]) + (len(payload) + 2).to_bytes(2, "big") \
        + payload


def encode(img, quality: int = 85, subsampling: str = "4:2:0") -> bytes:
    """uint8 [H, W, 3] RGB -> the JPEG file ``PIL.Image.save(
    format="JPEG", quality=quality)`` writes ("4:2:0", PIL's default;
    "4:4:4" is PIL's subsampling=0)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"encode: uint8 [H, W, 3] RGB only, got "
                         f"{img.dtype} {img.shape}")
    if subsampling not in SUBSAMPLING:
        raise ValueError(f"encode: subsampling {subsampling!r} is not one "
                         f"of {sorted(SUBSAMPLING)}")
    H, W = img.shape[:2]
    hmax, vmax = SUBSAMPLING[subsampling]
    hv = [(hmax, vmax), (1, 1), (1, 1)]
    mcux, mcuy = _cdiv(W, 8 * hmax), _cdiv(H, 8 * vmax)
    qtabs = quality_tables(quality)
    per_mcu = []
    for ci, (plane, (h, v)) in enumerate(zip(_rgb_to_ycc(img), hv)):
        if (h, v) != (hmax, vmax):           # 4:2:0 chroma
            plane = _downsample(plane, _cdiv(H, 2), _cdiv(_cdiv(W, 2), 8) * 8)
        full = _component_coefficients(plane[:_cdiv(H * v, vmax)],
                                       qtabs[min(ci, 1)], h, v, hmax, vmax,
                                       H, W)
        per_mcu.append(full.reshape(mcuy, v, mcux, h, 64).transpose(
            0, 2, 1, 3, 4).reshape(mcuy * mcux, v * h, 64))
    stream = np.concatenate(per_mcu, 1).reshape(-1, 64)
    comp_of = np.tile(np.concatenate([np.full(v * h, ci) for ci, (h, v)
                                      in enumerate(hv)]), mcuy * mcux)
    tables = []
    for t in range(2):
        tables.append(_code_table(*STD_HUFFMAN[("dc", t)]))
        tables.append(_code_table(*STD_HUFFMAN[("ac", t)]))
    values, lengths = _tokens(stream, comp_of, np.minimum(comp_of, 1),
                              tables)

    out = [b"\xff\xd8",
           _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t in range(2):
        out.append(_marker(0xDB, bytes([t]) + qtabs[t][NATURAL].astype(
            np.uint8).tobytes()))
    sof = bytes([8]) + H.to_bytes(2, "big") + W.to_bytes(2, "big") + b"\x03"
    for ci, (h, v) in enumerate(hv):
        sof += bytes([ci + 1, (h << 4) | v, min(ci, 1)])
    out.append(_marker(0xC0, sof))
    for t in range(2):
        for kind, tc in (("dc", 0), ("ac", 1)):
            bits, vals = STD_HUFFMAN[(kind, t)]
            out.append(_marker(0xC4, bytes([(tc << 4) | t]) + bytes(bits)
                               + vals))
    sos = b"\x03" + b"".join(bytes([ci + 1, 0x11 * min(ci, 1)])
                             for ci in range(3))
    out.append(_marker(0xDA, sos + b"\x00\x3f\x00"))
    out.append(_pack_bits(values, lengths))
    out.append(b"\xff\xd9")
    return b"".join(out)


def write_jpeg(path: str, img, quality: int = 85,
               subsampling: str = "4:2:0"):
    """``encode`` ``img`` into the file ``path``."""
    import os

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode(img, quality=quality, subsampling=subsampling))
