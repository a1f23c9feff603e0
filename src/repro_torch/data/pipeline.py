"""Deterministic, resumable synthetic data streams, a copy of
``repro.data.pipeline`` (numpy alone, the same seeds and cursor formula),
so the batches equal the reference's bit for bit.

``SyntheticLMStream`` emits token batches from a fixed random bigram
process: structure a model learns within a few hundred steps, with no
external data.  The cursor is part of the checkpointed state, so a resumed
run continues on the exact batch; each of ``process_count`` hosts draws
only its own slice.  ``FrameEmbedStream`` gives the stub modality
frontends' outputs (audio-frame or vision-patch embeddings).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLMStream:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 8          # bigram out-degree (lower = more learnable)
    process_index: int = 0
    process_count: int = 1
    cursor: int = 0             # batches already emitted (checkpointed)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V = self.vocab_size
        # the fixed bigram table: token t -> one of `branching` successors
        self._succ = rng.integers(0, V, size=(V, self.branching))
        if self.global_batch % self.process_count:
            raise ValueError(f"global_batch {self.global_batch} is not a "
                             f"multiple of {self.process_count} processes")
        self.local_batch = self.global_batch // self.process_count

    def state_dict(self) -> dict:
        return {"cursor": self.cursor, "seed": self.seed}

    def load_state_dict(self, st: dict) -> None:
        if int(st["seed"]) != self.seed:
            raise ValueError(f"stream seed {int(st['seed'])} on resume, "
                             f"this stream's is {self.seed}")
        self.cursor = int(st["cursor"])

    def next_batch(self) -> dict:
        """{"tokens": (local_batch, seq_len) int32} for this process."""
        # a generator per (cursor, process): reproducible, and the same
        # whatever order the hosts draw in; the walk is vectorized over rows
        rng = np.random.default_rng(self.seed * 1_000_003 + self.cursor * 131
                                    + self.process_index * 17)
        B, S = self.local_batch, self.seq_len
        out = np.empty((B, S), np.int32)
        t = rng.integers(0, self.vocab_size, size=B)
        branch = rng.integers(0, self.branching, size=(B, S))
        for s in range(S):
            out[:, s] = t
            t = self._succ[t, branch[:, s]]
        self.cursor += 1
        return {"tokens": out}


@dataclasses.dataclass
class FrameEmbedStream:
    """The stub modality frontend: precomputed frame or patch embeddings."""
    n_frames: int
    d_model: int
    global_batch: int
    seed: int = 0
    process_index: int = 0
    process_count: int = 1
    cursor: int = 0

    def __post_init__(self):
        if self.global_batch % self.process_count:
            raise ValueError(f"global_batch {self.global_batch} is not a "
                             f"multiple of {self.process_count} processes")
        self.local_batch = self.global_batch // self.process_count

    def next_batch(self) -> dict:
        """{"frames": (local_batch, n_frames, d_model) float32}."""
        rng = np.random.default_rng(self.seed + self.cursor * 977
                                    + self.process_index)
        self.cursor += 1
        return {"frames": rng.standard_normal(
            (self.local_batch, self.n_frames, self.d_model)).astype(
                np.float32) * 0.2}
