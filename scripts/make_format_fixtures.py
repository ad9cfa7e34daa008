#!/usr/bin/env python3
"""The image-format fixtures of ``tests/fixtures/formats/``: small files
of every PNG kind and progressive JPEG variant that the JAX package's
loader reads (through imageio and PIL), each beside what
``imageio.v3.imread`` and ``nerf_texture_tpu.data.provider._load_image``
return for it.

    python3 scripts/make_format_fixtures.py [--out tests/fixtures/formats]

Needs PIL, imageio and the JAX package, so it runs where those are
installed; ``chip_smoke.py`` (phase 18) and ``tests/test_torch_image_
formats.py`` read the files with the port alone and hold each decode to
the stored arrays bit for bit.  Every file is made from a fixed seed,
so a rerun writes the same files.

The PNGs are built chunk by chunk by ``png_bytes`` (numpy and zlib; PIL
writes neither Adam7 nor sub-byte palettes on request): palette PNGs at
1, 2, 4 and 8 bits with and without ``tRNS``, gray at 1, 2 and 4 bits
(1 bit: imageio returns booleans and the JAX loader raises), and Adam7
for RGB, RGBA, gray, gray-alpha, 16-bit RGBA, 4-bit gray and palette
images, one so small that passes are empty.  The JPEGs are PIL's
progressive files (libjpeg-turbo's default scan script) at 4:4:4, 4:2:2
and 4:2:0, gray, with restart intervals, at qualities 50 / 85 / 95 and
odd sizes, and one 800x800 frame of ``render_gt_sphere`` on white.

``manifest.json`` lists each file with its expected arrays: a ``.npy``
file, or for the 800x800 frame (whose 1.9 MB array would outweigh the
fixtures' budget) the SHA-256 of its bytes with its shape and dtype; a
file the JAX loader refuses has ``"load": {"raises": ...}``.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import struct
import sys
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Adam7: (first column, first row, column step, row step) of each pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """samples [h, w, c] (ints below 2^depth) -> packed rows [h, stride]
    uint8, sub-byte samples most significant first, 16-bit big-endian."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.int64)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1)
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


def _filter_rows(rows: np.ndarray, bpp: int, filters) -> bytes:
    """Each row [h, stride] uint8 encoded with the next filter type of
    ``filters`` (cycled)."""
    out = []
    prev = np.zeros(rows.shape[1], np.int64)
    for y, cur in enumerate(rows.astype(np.int64)):
        ft = filters[y % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ft == 0:
            enc = cur
        elif ft == 1:
            enc = cur - left
        elif ft == 2:
            enc = cur - prev
        elif ft == 3:
            enc = cur - (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
            enc = cur - np.where((pa <= pb) & (pa <= pc), left,
                                 np.where(pb <= pc, prev, ul))
        out.append(bytes([ft]) + (enc % 256).astype(np.uint8).tobytes())
        prev = cur
    return b"".join(out)


def png_bytes(samples: np.ndarray, depth: int, ctype: int, *,
              plte: bytes | None = None, trns: bytes | None = None,
              interlace: int = 0, filters=(0,)) -> bytes:
    """A PNG file of samples [h, w, c] (palette indices for colour type 3)
    at ``depth`` bits: the rows filtered with ``filters`` (cycled over the
    rows of each pass), Adam7 passes when ``interlace``."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    if interlace:
        raw = b""
        for x0, y0, dx, dy in ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                raw += _filter_rows(_pack_rows(sub, depth), bpp, filters)
    else:
        raw = _filter_rows(_pack_rows(samples, depth), bpp, filters)
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                       interlace))
    if plte is not None:
        body += _chunk(b"PLTE", plte)
    if trns is not None:
        body += _chunk(b"tRNS", trns)
    return (PNG_SIGNATURE + body + _chunk(b"IDAT", zlib.compress(raw, 9))
            + _chunk(b"IEND", b""))


def smooth_image(h: int, w: int, channels: int, seed: int,
                 noise: float = 8.0) -> np.ndarray:
    """uint8 [h, w, channels]: a bilinear blow-up of coarse random colour
    plus noise, so every DCT band and run length occurs."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((h // 4 + 2, w // 4 + 2, channels)) * 255
    ys = np.linspace(0, coarse.shape[0] - 1, h)
    xs = np.linspace(0, coarse.shape[1] - 1, w)
    y0, x0 = np.floor(ys).astype(int), np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, coarse.shape[0] - 1)
    x1 = np.minimum(x0 + 1, coarse.shape[1] - 1)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    img = (coarse[y0][:, x0] * (1 - fy) * (1 - fx)
           + coarse[y0][:, x1] * (1 - fy) * fx
           + coarse[y1][:, x0] * fy * (1 - fx) + coarse[y1][:, x1] * fy * fx)
    img = img + rng.normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def png_cases():
    """(name, file bytes) of the PNG fixtures."""
    rng = np.random.default_rng(12)
    out = []
    for depth in (1, 2, 4, 8):
        n = 1 << depth
        idx = rng.integers(0, n, (11, 13, 1))
        # a palette one entry short, so that an index past it occurs
        plte = rng.integers(0, 256, 3 * (n - 1 if depth > 1 else n),
                            dtype=np.uint8).tobytes()
        trns = bytes(rng.integers(0, 256, min(n, 5), dtype=np.uint8))
        for t in (None, trns):
            out.append((f"palette{depth}{'_trns' if t else ''}.png",
                        png_bytes(idx, depth, 3, plte=plte, trns=t,
                                  filters=(0, 1, 2, 3, 4))))
    for depth in (1, 2, 4):
        g = rng.integers(0, 1 << depth, (9, 17, 1))
        out.append((f"gray{depth}.png", png_bytes(g, depth, 0,
                                                  filters=(4, 3, 1))))
    for name, c, ctype, depth in (("rgb", 3, 2, 8), ("rgba", 4, 6, 8),
                                  ("gray", 1, 0, 8), ("gray_alpha", 2, 4, 8),
                                  ("rgba16", 4, 6, 16), ("gray4", 1, 0, 4)):
        s = rng.integers(0, 1 << depth, (21, 19, c))
        s[8:] = smooth_image(13, 19, c, seed=c) >> (8 - min(depth, 8))
        out.append((f"adam7_{name}.png",
                    png_bytes(s, depth, ctype, interlace=1,
                              filters=(0, 1, 2, 3, 4))))
    idx = rng.integers(0, 256, (15, 10, 1))
    plte = rng.integers(0, 256, 768, dtype=np.uint8).tobytes()
    out.append(("adam7_palette8.png", png_bytes(idx, 8, 3, plte=plte,
                                                interlace=1,
                                                filters=(4, 2))))
    idx = rng.integers(0, 4, (3, 2, 1))
    out.append(("adam7_palette2_tiny.png",
                png_bytes(idx, 2, 3, plte=plte[:12], trns=b"\x00",
                          interlace=1, filters=(1,))))
    return out


def jpeg_cases():
    """(name, file bytes) of PIL's progressive JPEG fixtures."""
    from PIL import Image

    from nerf_texture_tpu_torch.data.poses import orbit_pose
    from nerf_texture_tpu_torch.data.synthetic import (render_gt_sphere,
                                                       sphere_intrinsics)

    def save(img, **kw):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", progressive=True, **kw)
        return buf.getvalue()

    out = []
    for k, (sub, q, (h, w)) in enumerate((("444", 95, (37, 45)),
                                          ("422", 50, (61, 30)),
                                          ("420", 85, (35, 43)))):
        img = smooth_image(h, w, 3, seed=20 + k)
        out.append((f"progressive_{sub}_q{q}.jpg",
                    save(img, quality=q,
                         subsampling={"444": 0, "422": 1, "420": 2}[sub])))
    gray = smooth_image(29, 51, 1, seed=30)[..., 0]
    out.append(("progressive_gray_q85.jpg", save(gray, quality=85)))
    out.append(("progressive_gray_restart.jpg",
                save(gray, quality=50, restart_marker_blocks=2)))
    out.append(("progressive_420_restart.jpg",
                save(smooth_image(40, 57, 3, seed=31), quality=85,
                     restart_marker_blocks=3)))
    out.append(("progressive_420_optimize_q95.jpg",
                save(smooth_image(33, 47, 3, seed=32), quality=95,
                     optimize=True)))
    rgba = render_gt_sphere(orbit_pose(1.2, 0.7, 2.0),
                            sphere_intrinsics(800, 800), 800, 800)
    rgba = rgba.astype(np.float32) / 255.0
    rgb = rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:])
    out.append(("progressive_sphere_800.jpg",
                save((rgb * 255).astype(np.uint8), quality=90)))
    return out


def expected(arr: np.ndarray, stem: str, out_dir: str,
             inline_limit: int = 65536) -> dict:
    """An expected array: saved as ``<stem>.npy``, or by hash when it is
    larger than ``inline_limit`` bytes."""
    if arr.nbytes > inline_limit:
        return {"sha256": hashlib.sha256(
            np.ascontiguousarray(arr).tobytes()).hexdigest(),
            "shape": list(arr.shape), "dtype": str(arr.dtype)}
    np.save(os.path.join(out_dir, stem + ".npy"), arr, allow_pickle=False)
    return {"npy": stem + ".npy"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "fixtures",
                                                  "formats"))
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import imageio.v3 as iio

    from nerf_texture_tpu.data.provider import _load_image

    os.makedirs(args.out, exist_ok=True)
    for f in os.listdir(args.out):
        os.remove(os.path.join(args.out, f))
    manifest = {}
    for name, data in png_cases() + jpeg_cases():
        path = os.path.join(args.out, name)
        with open(path, "wb") as f:
            f.write(data)
        stem = os.path.splitext(name)[0]
        entry = {"imread": expected(iio.imread(path), stem + ".imread",
                                    args.out)}
        try:
            entry["load"] = expected(_load_image(path), stem + ".load",
                                     args.out)
        except ValueError as e:
            entry["load"] = {"raises": f"{type(e).__name__}: {e}"}
        manifest[name] = entry
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    size = sum(os.path.getsize(os.path.join(args.out, f))
               for f in os.listdir(args.out))
    print(f"{len(manifest)} fixtures, {size} bytes in {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
