# Planted REX002 corpus in kernels/: unseeded draws in a kernel's inputs.
# rex-expect: REX002=3
import torch


def make_inputs(shape, gen):
    idx = torch.randint(0, 4, shape)                  # planted: default gen
    w = torch.empty(shape)
    w.uniform_()                                      # planted: in-place
    torch.nn.init.trunc_normal_(w)                    # planted: init draw
    q = torch.randint(0, 4, shape, generator=gen)     # seeded: fine
    torch.nn.init.trunc_normal_(w, generator=gen)     # seeded: fine
    return idx, w, q


def _round_body(x):
    # no hot function lives in kernels/: REX001 does not apply here
    return x.item()
