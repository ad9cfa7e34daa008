"""Image files without an image library: a PNG reader and writer on
``zlib`` and numpy, and a Lanczos resampler with PIL's integer arithmetic.

``load_image`` is the counterpart of the JAX package's
``provider._load_image`` (imageio) and ``resize`` of its ``_resize``
(``PIL.Image.resize(..., LANCZOS)``); tests hold both to those libraries
bit for bit.  What imageio makes of a PNG is kept: 16-bit RGB(A) keeps
the high byte of each sample, 16-bit gray is scaled to uint8 in f32 as
the JAX loader does, 16-bit gray-alpha becomes RGBA, 8-bit gray-alpha
stays two channels, and gray becomes three channels.  Palette, interlaced
and sub-byte PNGs raise.  A JPEG is read by ``data.jpeg`` (baseline
sequential files, bit for bit as PIL decodes them); any other format
raises naming the file.
"""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np

from .jpeg import read_jpeg

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels of each PNG colour type (palette, 3, is not read)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


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
    [h, stride] uint8."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected "
                         f"{h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
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


def read_png(path: str) -> np.ndarray:
    """A PNG file as imageio reads it: uint8 [H, W] (gray), [H, W, 2]
    (gray-alpha), [H, W, 3] or [H, W, 4]; uint16 [H, W] for 16-bit gray.
    8- and 16-bit samples, every row filter, no interlace, no palette."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    ihdr, idat = None, []
    for tag, body in _png_chunks(data):
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype == 3:
        raise ValueError(f"{path}: palette PNGs are not read")
    if ctype not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"{path}: PNG colour type {ctype} at bit depth "
                         f"{depth} is not read (8 or 16 bits of gray, "
                         f"gray-alpha, RGB or RGBA)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not read")
    c = _CHANNELS[ctype]
    bpp = c * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 8:
        img = rows.reshape(h, w, c)
    else:
        img = rows.view(">u2").reshape(h, w, c)
        if ctype == 0:
            return img[..., 0].astype(np.uint16)
        # imageio (through PIL) keeps the high byte of 16-bit colour,
        # and reads 16-bit gray-alpha as RGBA
        img = (img >> 8).astype(np.uint8)
        if ctype == 4:
            img = img[..., [0, 0, 0, 1]]
    return img[..., 0] if c == 1 else np.ascontiguousarray(img)


def write_png(path: str, img: np.ndarray):
    """Write img [H, W, 3] (or [H, W, 4]) uint8 as an 8-bit RGB (RGBA)
    PNG: one IDAT chunk, filter type 0 on every row."""
    h, w, c = img.shape
    raw = b"".join(b"\x00" + row.tobytes()
                   for row in np.ascontiguousarray(img, np.uint8))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, {3: 2, 4: 6}[c], 0, 0, 0)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def load_image(path: str) -> np.ndarray:
    """A scene image as the JAX loader has it: uint8 [H, W, C], C = 3 or 4
    (2 for 8-bit gray-alpha); other integer types scaled to uint8 in f32,
    gray made three channels.  PNG and baseline JPEG are read."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == PNG_SIGNATURE:
        img = read_png(path)
    elif head[:2] == b"\xff\xd8":
        img = read_jpeg(path)
    else:
        raise ValueError(f"{path}: neither a PNG nor a JPEG file")
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
