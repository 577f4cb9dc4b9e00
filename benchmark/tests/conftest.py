"""The benchmark's tests: the repository root on the import path (for
``benchmark`` and the package under test) and one torch thread a worker."""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
torch.set_num_threads(1)

# each cell at a size the CPU tests can hold: the same code paths, a few
# members, a short horizon, a small surrogate fitted in a few steps
TINY = {
    "quadrotor_mlp.track_b2048": {
        "config": {"H": 6, "hidden": [16, 16],
                   "fit": {"n": 2048, "steps": 200, "batch": 512}},
        "traffic": {"batch": 4, "lead_in": 1, "check_per_replan": 4,
                    "trace_replans": 1}},
}
CELLS = tuple(TINY)
