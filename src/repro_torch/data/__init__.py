"""Deterministic, resumable synthetic data streams."""
from repro_torch.data.pipeline import (FrameEmbedStream,  # noqa: F401
                                       SyntheticLMStream)
