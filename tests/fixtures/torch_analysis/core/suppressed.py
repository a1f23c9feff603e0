# Clean under lint: file-level suppression silences every REX002 below.
# rex: disable-file=REX002
import random

import torch
from numpy.random import default_rng


def chaos_probe(n):
    # deliberate nondeterminism (a fault-injection helper would live here);
    # the file-level waiver above keeps the gate quiet
    return default_rng(), random.random(), torch.randn(n)
