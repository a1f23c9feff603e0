# Planted REX001 corpus: the M-RoPE stream index copied from the host at
# every call, beside the rotary frequencies copied once (functools.cache).
# rex-expect: REX001=3
import functools

import numpy as np
import torch


@functools.cache
def _freqs(head_dim, device):
    f = 1.0 / 10000 ** (np.arange(0, head_dim, 2) / head_dim)
    return torch.as_tensor(f, device=device)         # planted: once a device


def _mrope_streams(sections, device):
    src = np.repeat(np.arange(3), sections)
    return torch.as_tensor(src, device=device)       # planted: every call


def apply_rope(x, positions):
    return x * (positions[..., None] * _freqs(x.shape[-1], x.device))


def apply_mrope(x, positions3, sections):
    src = _mrope_streams(sections, x.device)         # planted: uncached
    return x * positions3[src].sum(0)[..., None]
