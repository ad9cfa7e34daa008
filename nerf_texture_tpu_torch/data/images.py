"""Image files without an image library: a PNG reader and writer on
``zlib`` and numpy, and a Lanczos resampler with PIL's integer arithmetic.

``load_image`` is the counterpart of the JAX package's
``provider._load_image`` (imageio) and ``resize`` of its ``_resize``
(``PIL.Image.resize(..., LANCZOS)``); ``read_image`` returns what
``imageio.v3.imread`` returns for a PNG or a JPEG.  Tests hold all three
to those libraries bit for bit.  What imageio makes of a PNG is kept:
16-bit RGB(A) keeps the high byte of each sample, 16-bit gray is scaled
to uint8 in f32 as the JAX loader does, 16-bit gray-alpha becomes RGBA,
8-bit gray-alpha stays two channels, and gray becomes three channels.
A palette PNG (1, 2, 4 or 8 bits) is expanded through its ``PLTE`` to
RGB, with any ``tRNS`` dropped and indices past the palette black;
2- and 4-bit gray is scaled to 8 bits (x 85, x 17); 1-bit gray reads as
booleans, which ``load_image`` refuses as the JAX loader does.  Adam7
interlaced files are read for every colour type and depth.  A JPEG is
read by ``data.jpeg`` (baseline, extended and progressive Huffman files,
bit for bit as PIL decodes them); any other format raises naming the
file.
"""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np

from .jpeg import read_jpeg

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels of each PNG colour type (3: palette indices), and the bit
# depths the PNG standard allows for it
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7: (first column, first row, column step, row step) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        yield tag, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IEND":
            return


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (0 none, 1 sub, 2 up, 3 average, 4 paeth):
    [h, stride] uint8.  Bytes past the image are ignored, as libpng (and
    PIL) ignore them; too few raise."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size < h * (stride + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected "
                         f"{h * (stride + 1)}")
    rows = rows[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:
            # a running sum per byte lane, modulo 256
            cur = np.cumsum(line.reshape(-1, bpp).astype(np.int64),
                            axis=0).astype(np.uint8).reshape(-1)
        elif ftype == 2:
            cur = line + prev
        elif ftype in (3, 4):
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                    continue
                c = up[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc
                                                          else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {y} has filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def _samples(rows: np.ndarray, w: int, c: int, depth: int) -> np.ndarray:
    """Unfiltered rows [h, stride] -> samples [h, w, c]: uint8 for depths
    of 1-8 bits (sub-byte samples unpacked, most significant first, not
    scaled), big-endian uint16 for 16."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :w * c].reshape(h, w, c)
    if depth == 16:
        return rows[:, :2 * w * c].view(">u2").reshape(h, w, c)
    bits = np.unpackbits(rows, axis=1)[:, :w * c * depth]
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits.reshape(h, w * c, depth) * weights).sum(
        -1, dtype=np.uint8).reshape(h, w, c)


def _decode_pixels(raw: bytes, w: int, h: int, c: int, depth: int,
                   interlace: int, path: str) -> np.ndarray:
    """The zlib-inflated image data -> samples [h, w, c]: one filtered
    image, or Adam7's seven passes, each filtered on its own with its own
    row width (an empty pass has no bytes at all)."""
    bpp = max(1, c * depth // 8)

    def stride(width):
        return (width * c * depth + 7) // 8

    if not interlace:
        return _samples(_unfilter(raw, h, stride(w), bpp), w, c, depth)
    out = np.zeros((h, w, c), np.uint8 if depth <= 8 else ">u2")
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        n = ph * (stride(pw) + 1)
        if pos + n > len(raw):
            raise ValueError(f"{path}: interlaced PNG data holds "
                             f"{len(raw)} bytes, its passes more")
        rows = _unfilter(raw[pos:pos + n], ph, stride(pw), bpp)
        out[y0::dy, x0::dx] = _samples(rows, pw, c, depth)
        pos += n
    return out


def read_png(path: str) -> np.ndarray:
    """A PNG file as imageio reads it: uint8 [H, W] (gray), [H, W, 2]
    (gray-alpha), [H, W, 3] (RGB, palette) or [H, W, 4]; uint16 [H, W]
    for 16-bit gray; bool [H, W] for 1-bit gray.  Every colour type and
    bit depth of the PNG standard, every row filter, Adam7 interlace."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    ihdr, plte, idat = None, None, []
    for tag, body in _png_chunks(data):
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = body
        elif tag == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise ValueError(f"{path}: PNG colour type {ctype} at bit depth "
                         f"{depth} is not a valid PNG")
    if interlace not in (0, 1):
        raise ValueError(f"{path}: PNG interlace method {interlace}")
    if ctype == 3:
        # imageio (through PIL) converts to the palette's mode, RGB: tRNS
        # is dropped, and an index past the palette reads as black
        if plte is None:
            raise ValueError(f"{path}: palette PNG without a PLTE chunk")
        if len(plte) > 256 * 3:
            raise ValueError(f"{path}: invalid palette size "
                             f"({len(plte)} bytes)")
        lut = np.zeros((256, 3), np.uint8)
        n = len(plte) // 3
        lut[:n] = np.frombuffer(plte[:3 * n], np.uint8).reshape(n, 3)
    c = _CHANNELS[ctype]
    img = _decode_pixels(zlib.decompress(b"".join(idat)), w, h, c, depth,
                         interlace, path)
    if ctype == 3:
        return lut[img[..., 0]]
    if depth < 8:
        # PIL's "1", "L;2" and "L;4" modes: booleans, or 8-bit gray
        if depth == 1:
            return img[..., 0] != 0
        return img[..., 0] * np.uint8(255 // ((1 << depth) - 1))
    if depth == 16:
        if ctype == 0:
            return img[..., 0].astype(np.uint16)
        # imageio (through PIL) keeps the high byte of 16-bit colour,
        # and reads 16-bit gray-alpha as RGBA
        img = (img >> 8).astype(np.uint8)
        if ctype == 4:
            img = img[..., [0, 0, 0, 1]]
    return img[..., 0] if c == 1 else np.ascontiguousarray(img)


def write_png(path: str, img: np.ndarray):
    """Write img [H, W] (or [H, W, 3], [H, W, 4]) uint8 as an 8-bit gray
    (RGB, RGBA) PNG: one IDAT chunk, filter type 0 on every row."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if img.dtype != np.uint8 or c not in (1, 3, 4):
        raise ValueError(f"write_png: uint8 [H, W], [H, W, 3] or [H, W, 4] "
                         f"only, got {img.dtype} {img.shape}")
    raw = b"".join(b"\x00" + row.tobytes()
                   for row in np.ascontiguousarray(img, np.uint8))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[c], 0, 0, 0)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def read_image(path: str) -> np.ndarray:
    """What ``imageio.v3.imread`` returns for a PNG (``read_png``) or a
    JPEG (``data.jpeg.read_jpeg``): the format is told by the file's
    first bytes."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == PNG_SIGNATURE:
        return read_png(path)
    if head[:2] == b"\xff\xd8":
        return read_jpeg(path)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")


def load_image(path: str) -> np.ndarray:
    """A scene image as the JAX loader has it: uint8 [H, W, C], C = 3 or 4
    (2 for 8-bit gray-alpha); other integer types scaled to uint8 in f32,
    gray made three channels.  A 1-bit gray PNG raises: imageio reads it
    as booleans, which the JAX loader cannot scale either."""
    img = read_image(path)
    if img.dtype == np.bool_:
        raise ValueError(f"{path}: a 1-bit gray PNG reads as booleans "
                         f"(as imageio reads it), which the scene loader "
                         f"does not scale to uint8; the JAX loader raises "
                         f"on it too")
    if img.dtype != np.uint8:
        img = (np.clip(img.astype(np.float32) / np.iinfo(img.dtype).max,
                       0, 1) * 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img


# ---------------------------------------------------------------------------
# Lanczos resampling with PIL's fixed-point arithmetic
# ---------------------------------------------------------------------------

_PRECISION_BITS = 32 - 8 - 2


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


def _coeffs(in_size: int, out_size: int):
    """PIL's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for the
    Lanczos filter (support 3): per output pixel its first input pixel,
    and [out, ksize] int64 weights in 22-bit fixed point."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        if ww != 0.0:
            k = [w / ww for w in k]
        for x, w in enumerate(k):
            kk[xx, x] = int((-0.5 if w < 0 else 0.5)
                            + w * (1 << _PRECISION_BITS))
        xmins[xx] = xmin
    return xmins, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of PIL's 8bpc resampler along ``axis`` (0 rows, 1 columns)
    of img [H, W, C] uint8, clipped to uint8 as PIL clips between
    passes."""
    in_size = img.shape[axis]
    xmins, kk = _coeffs(in_size, out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    bcast = (slice(None),) + (None,) * (src.ndim - 1)
    for j in range(kk.shape[1]):
        # a zero weight past a window's end reads any in-range pixel
        idx = np.minimum(xmins + j, in_size - 1)
        acc += src[idx] * kk[:, j][bcast]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _premultiply(img: np.ndarray) -> np.ndarray:
    """PIL's RGBA -> RGBa (LA -> La): colour x alpha / 255, rounded as
    its MULDIV255."""
    out = img.copy()
    a = img[..., -1:].astype(np.int64)
    t = img[..., :-1].astype(np.int64) * a + 128
    out[..., :-1] = ((t >> 8) + t) >> 8
    return out


def _unpremultiply(img: np.ndarray) -> np.ndarray:
    """PIL's RGBa -> RGBA (La -> LA): colour x 255 / alpha, truncated and
    clipped, where alpha is neither 0 nor 255."""
    out = img.copy()
    a = img[..., -1:].astype(np.int64)
    c = img[..., :-1].astype(np.int64)
    safe = np.where((a == 0) | (a == 255), 1, a)
    scaled = np.clip((255 * c) // safe, 0, 255)
    out[..., :-1] = np.where((a == 0) | (a == 255), c, scaled)
    return out


def resize(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """``np.asarray(PIL.Image.fromarray(img).resize((w, h), LANCZOS))``
    for img [H, W] or [H, W, C] uint8 (C = 2, 3 or 4): a horizontal then
    a vertical pass of PIL's fixed-point resampler, colour premultiplied
    by alpha around them as PIL does."""
    if img.dtype != np.uint8:
        raise ValueError(f"resize: uint8 images only, not {img.dtype}")
    gray = img.ndim == 2
    out = img[..., None] if gray else img
    if out.shape[:2] == (h, w):
        return img.copy()
    alpha = out.shape[-1] in (2, 4)
    if alpha:
        out = _premultiply(out)
    if out.shape[1] != w:
        out = _resample_axis(out, w, 1)
    if out.shape[0] != h:
        out = _resample_axis(out, h, 0)
    if alpha:
        out = _unpremultiply(out)
    return out[..., 0] if gray else out
