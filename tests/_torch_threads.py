"""One torch intra-op thread for the port's CPU tests.

The test run starts several worker processes, one per core or so; at
torch's default thread count each worker's small batched solves would
spread over every core at once and the workers would contend for them.
Every ``tests/test_torch_*.py`` imports this module first (pinned by
``test_torch_isolation.py``), so each worker's torch runs on one thread.
"""

import torch

torch.set_num_threads(1)
