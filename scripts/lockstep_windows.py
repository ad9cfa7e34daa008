"""Window statistics of a lockstep log written by ``scripts/shell_lockstep.py``
(a TSV of step, both losses and their differences).

For each log: the mean absolute loss difference over steps 17-96 (after
the first refresh cycle), 97-200, 201-400 and 401-700 (as far as the log
reaches), the mean signed difference (second minus first) over 401-700,
the first step after 96 whose difference passes 0.1, and how many do.
Then, for each pair of logs, the same windows between their first loss
columns (the JAX package's side of two runs on the same init and
draws): how far the reference parts from its own run.

    python scripts/lockstep_windows.py build/shell_lockstep/bench_curved.tsv \
        build/shell_lockstep/bench_curved_control.tsv
"""

from __future__ import annotations

import json
import sys

import numpy as np

WINDOWS = ((17, 96), (97, 200), (201, 400), (401, 700))


def load(path: str):
    d = np.genfromtxt(path, names=True, delimiter="\t")
    return d["step"].astype(int), d[d.dtype.names[1]], d[d.dtype.names[2]]


def windows(path: str, second: str | None = None) -> dict:
    step, first, other = load(path)
    out = {"log": path}
    if second is not None:          # the first column of another run
        step2, other, _ = load(second)
        assert np.array_equal(step, step2)
        out["against"] = second
    gap = other - first
    diff = np.abs(gap)
    out["steps"] = int(step.max())
    for lo, hi in WINDOWS:
        m = (step >= lo) & (step <= hi)
        if m.any():
            out[f"mean_abs_{lo}_{hi}"] = float(diff[m].mean())
    late = (step >= 401) & (step <= 700)
    if late.any():
        out["mean_signed_401_700"] = float(gap[late].mean())
    over = step[(step > 96) & (diff > 0.1)]
    out["first_past_0.1_after_96"] = int(over[0]) if len(over) else None
    out["steps_past_0.1_after_96"] = int(len(over))
    out["max_abs_after_96"] = float(diff[step > 96].max()) \
        if (step > 96).any() else None
    return out


if __name__ == "__main__":
    logs = sys.argv[1:]
    for p in logs:
        print(json.dumps(windows(p)))
    for i, a in enumerate(logs):
        for b in logs[i + 1:]:
            print(json.dumps(windows(a, b)))
