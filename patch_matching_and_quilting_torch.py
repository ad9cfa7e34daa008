"""Flat texture synthesis with the PyTorch port (``nerf_texture_tpu_torch``):
the same arguments and output as ``patch_matching_and_quilting.py``.

Reads the field npz that ``field_io.save_field`` exports, quilts its
patches (features, phi embedding and local TBN stacked per texel) into a
canvas on the host, and writes texture.npz beside it, which
``field_io.load_field`` imports.

Usage:
  python patch_matching_and_quilting_torch.py \
      logs/<scene>/field/<name>.npz --output_size 2048 --mode Cut
"""

import argparse
import os

import numpy as np

from nerf_texture_tpu_torch.synthesis.quilting import (QuiltingConfig,
                                                       QuiltingSynthesizer)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("field_npz")
    p.add_argument("--output_size", type=int, default=2048)
    p.add_argument("--mode", default="Cut", choices=["Cut", "blend"])
    p.add_argument("--mirror_hor", action="store_true")
    p.add_argument("--mirror_vert", action="store_true")
    p.add_argument("--no_strict_match", action="store_true")
    p.add_argument("--patch_size", type=int, default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    data = np.load(args.field_npz, allow_pickle=True)
    patches = data["patches"]
    match_dim = patches.shape[-1]
    phi_dim = 0
    parts = [patches]
    if "patch_phi_embed" in data and data["patch_phi_embed"].ndim > 1:
        phi_dim = data["patch_phi_embed"].shape[-1]
        parts.append(data["patch_phi_embed"])
    if "patch_local_tbn" in data and data["patch_local_tbn"].ndim > 1:
        ltbn = data["patch_local_tbn"]
        parts.append(ltbn.reshape(*ltbn.shape[:3], 9))
    stacked = np.concatenate(parts, -1)
    print("patches:", stacked.shape)

    cfg = QuiltingConfig(
        output_size=(args.output_size, args.output_size),
        patch_size=args.patch_size, mirror_hor=args.mirror_hor,
        mirror_vert=args.mirror_vert,
        strict_match=not args.no_strict_match, mode=args.mode,
        seed=args.seed)
    syn = QuiltingSynthesizer(
        stacked, cfg, match_dim=match_dim,
        sample_tbn=data["patch_sample_tbn"],
        picked_vertices=data["picked_vertices"],
        patch_length=patches.shape[1] * float(data["grid_gap"]))
    syn.synthesize(progress=True)
    out = syn.export(grid_gap=float(data["grid_gap"]),
                     phi_embed_dim=phi_dim)
    out_path = args.out or os.path.join(
        os.path.dirname(args.field_npz), "texture.npz")
    np.savez(out_path, **{k: v for k, v in out.items() if v is not None})
    print("saved", out_path)
    return out_path


if __name__ == "__main__":
    main()
