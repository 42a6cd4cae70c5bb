"""Sets torch to one intra-op thread in the port's test processes.

Every ``tests/test_torch_*.py`` imports this module. The tier-1 run is
``pytest -n 6 --dist loadfile``: six workers share the cores, and torch's
default of one intra-op thread per core in each of them oversubscribes the
machine many times over, so a test that takes seconds alone takes minutes
beside five others. At one thread the goldens still match byte for byte.
"""
import torch

torch.set_num_threads(1)
