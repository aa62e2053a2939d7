"""One torch intra-op thread in every process that runs the port's tests.

Each `tests/test_torch_*.py` calls `one_torch_thread()` at import (held
by `tests/test_torch_package.py`). The tests run several pytest workers
on one machine; with torch's default of one intra-op thread per core,
the workers' small eager ops wait on one another, and the CPU-side
tensors here are small enough that one thread is the fastest anyway.
The port package itself never changes torch's thread count: a user's
process keeps its own setting.
"""
import torch


def one_torch_thread():
    torch.set_num_threads(1)
