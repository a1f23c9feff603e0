# Planted REX002 corpus: unseeded or process-global RNG, numpy's, the
# stdlib's and torch's.
# rex-expect: REX002=10
import random

import numpy as np
import torch
from numpy.random import default_rng
from torch import randperm as perm


def sample_replay(n, x):
    rng = default_rng()                      # planted: unseeded default_rng
    jitter = np.random.randint(0, 4)         # planted: legacy global RNG
    coin = random.random()                   # planted: stdlib global RNG
    keep = random.shuffle                    # bare reference, not a call: fine
    noise = torch.randn(n)                   # planted: default generator
    like = torch.rand_like(x)                # planted: default generator
    order = perm(n)                          # planted: an imported draw
    x.normal_()                              # planted: in-place draw
    return rng, jitter, coin, keep, noise, like, order


def reseed(seed):
    torch.manual_seed(seed)                  # planted: global seed
    torch.seed()                             # planted: global reseed
    torch.cuda.manual_seed_all(seed)         # planted: every card's


def sample_seeded(n, x, seed):
    gen = torch.Generator().manual_seed(seed)    # a seeded generator: fine
    noise = torch.randn(n, generator=gen)        # seeded draw: fine
    x.normal_(generator=gen)                     # seeded in-place: fine
    rng = default_rng(seed)                      # seeded: fine
    burn = torch.rand(n)                         # rex: disable=REX002
    return noise, rng, burn
