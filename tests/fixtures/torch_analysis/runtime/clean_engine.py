# Fully clean fixture: the discipline every rule asks for, in one file.
import numpy as np
import torch


def rank_round(scores, k):
    return torch.topk(scores, k, dim=-1)


class CleanEngine:
    def _round_body(self, frames, seed, dev):
        gen = torch.Generator(device=dev).manual_seed(seed)
        crops = np.stack([np.asarray(f) for f in frames])
        noise = torch.randn(crops.shape, generator=gen, device=dev)
        order = np.random.default_rng(seed).permutation(len(frames))
        wanted = {int(i) for i in order[:2]}
        return noise, [crops[i] for i in sorted(wanted)]

    def _scatter(self, qs, state):
        for i, q in enumerate(qs):
            q.phase = int(state["phase"][i])
