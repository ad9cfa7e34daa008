"""Seeding, the metrics log and a profiler trace (port of
``seed_everything``, ``MetricsLogger`` and ``profile_trace`` of
``nerf_texture_tpu/utils/misc.py``)."""

from __future__ import annotations

import contextlib
import json
import os
import random
import time

import numpy as np


def seed_everything(seed: int):
    """Seed Python's and numpy's global generators and PYTHONHASHSEED.
    The port's own draws come from explicit ``torch.Generator``s."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)


class MetricsLogger:
    """Append-mode jsonl scalar log ``log_<name>.jsonl`` in ``workspace``,
    with a plain-text mirror ``log_<name>.txt``."""

    def __init__(self, workspace: str, name: str = "train"):
        os.makedirs(workspace, exist_ok=True)
        self.jsonl = os.path.join(workspace, f"log_{name}.jsonl")
        self.txt = os.path.join(workspace, f"log_{name}.txt")

    def log(self, step: int, **scalars):
        rec = {"step": int(step), "time": time.time(),
               **{k: float(v) for k, v in scalars.items()}}
        with open(self.jsonl, "a") as f:
            f.write(json.dumps(rec) + "\n")
        with open(self.txt, "a") as f:
            f.write(f"[{rec['step']}] " + " ".join(
                f"{k}={v:.6g}" for k, v in scalars.items()) + "\n")


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """torch.profiler trace of the block (host ops, and the card's kernels
    when there is one), written to ``log_dir/trace.json`` in the Chrome
    trace format on exit; yields the profiler."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
