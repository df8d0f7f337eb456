"""CPU settings of the port's parity tests, imported by every
``tests/test_torch_*.py``.

The tests run under ``pytest -n 6`` on a machine of a few cores, and
their tensors are at smoke widths: PyTorch's intra-op threads (one per
core in each worker) then only contend with the other workers, and the
whole suite takes about twice as long as with one thread per worker. So
each worker's PyTorch runs one intra-op thread. The results are held at
the same tolerances either way (a reduction may sum in another order).
"""
import torch

torch.set_num_threads(1)
