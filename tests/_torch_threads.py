"""Imported first by every ``tests/test_torch_*.py``: one intra-op thread
for torch in this process.

The suite runs under pytest-xdist with several workers, and each worker
imports every test module. Left at its default, each worker's torch spreads
its intra-op threads over every core beside the other workers, and the
port's small CPU tensors then run many times slower than in one thread.
Results do not depend on the thread count the tests compare at."""
import torch

torch.set_num_threads(1)
