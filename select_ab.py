#!/usr/bin/env python3
"""Times the selection kernels of another checkout of the port beside this
tree's, in turns on one CUDA card.

    python3 select_ab.py DIR

DIR holds another commit's ``nerf_texture_tpu_torch/`` (say the parent's:
``mkdir -p build/parent && git archive <commit> nerf_texture_tpu_torch |
tar -x -C build/parent``), whose kernels build from its own ``csrc/`` into
DIR/build/kernels.  At each shape that ``chip_smoke.py`` times in its
timing phase, both wrappers are timed as that phase times them (the median
kernel duration of 60 launches from torch.profiler, cold and warm, and
the wrapper's host time a call) in the order other, this, this, other on
the same inputs, and one line a shape gives every reading and the means
of each side.  The host's time a call drifts by tens of percent between
such passes, so a second line a shape times the two wrappers in
HOST_ROUNDS interleaved batches of WRAPPER_CALLS calls each (which one
goes first alternates) and gives each side's median and least batch.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import importlib
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as smoke

HOST_ROUNDS = 40


def load_other(root: str):
    """``ops/proxy_select`` of the port under ``root``, imported as the
    package ``other_port`` so that it sits beside this tree's."""
    pkg = Path(root).resolve() / "nerf_texture_tpu_torch"
    if not (pkg / "csrc" / "proxy_select.cu").is_file():
        raise SystemExit(f"select_ab: no nerf_texture_tpu_torch/csrc/"
                         f"proxy_select.cu under {root}")
    spec = importlib.util.spec_from_file_location(
        "other_port", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_port"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("other_port.ops.proxy_select")


def host_us(select, args, cap: int) -> float:
    """Host time (us) a call of ``select`` over WRAPPER_CALLS back-to-back
    calls, from an idle card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(smoke.WRAPPER_CALLS):
        select(*args, cap=cap, w_eps=1e-4)
    dt = (time.perf_counter() - t0) / smoke.WRAPPER_CALLS * 1e6
    torch.cuda.synchronize()
    return dt


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        print("select_ab: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    from nerf_texture_tpu_torch.ops import proxy_select as this

    other = load_other(sys.argv[1])
    dev = torch.device("cuda", 0)
    flush = torch.empty(smoke.FLUSH_BYTES // 4, device=dev)
    for seed, (kind, N, K, cap) in enumerate(smoke.TIMED_SHAPES):
        args = smoke.selection_inputs(N, K, 30 + seed, dev)
        fname = "proxy_select" if kind == "topk" else "proxy_select_cdf"
        runs = {"other": [], "this": []}
        for tag, mod in (("other", other), ("this", this), ("this", this),
                         ("other", other)):
            runs[tag].append(smoke.time_select(getattr(mod, fname), args,
                                               cap, flush))
        bound_ms, _, _ = smoke.select_bound(kind, N, K, cap)

        def side(tag):
            rs = runs[tag]
            mean = {k: float(np.mean([r[k] for r in rs])) for k in rs[0]}
            cold = ", ".join(f"{r['device_us']:.2f}" for r in rs)
            return (f"{tag}: cold {cold} (mean {mean['device_us']:.2f}) "
                    f"us, warm {mean['device_us_warm']:.2f} us, wrapper "
                    f"{mean['wrapper_us']:.2f} us a call")
        print(f"ab: {fname} [{N}, {K}] cap {cap}: {side('other')}; "
              f"{side('this')}; bound {bound_ms * 1e3:.3f} us ({card})")
        host = {"other": [], "this": []}
        pair = [("other", getattr(other, fname)),
                ("this", getattr(this, fname))]
        for i in range(HOST_ROUNDS):
            for tag, select in (pair if i % 2 == 0 else pair[::-1]):
                host[tag].append(host_us(select, args, cap))
        sides = "; ".join(f"{tag} median {np.median(v):.2f} us, least "
                          f"{min(v):.2f} us" for tag, v in host.items())
        print(f"ab: {fname} [{N}, {K}] cap {cap} wrapper, {HOST_ROUNDS} "
              f"interleaved batches: {sides} a call ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
