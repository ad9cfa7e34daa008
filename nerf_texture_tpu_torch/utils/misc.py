"""Seeding and the metrics log (port of ``seed_everything`` and
``MetricsLogger`` of ``nerf_texture_tpu/utils/misc.py``)."""

from __future__ import annotations

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
