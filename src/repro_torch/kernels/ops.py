"""Public kernel entry points.

A CPU tensor goes to the kernel's plain PyTorch version, a CUDA tensor to
the hand-written kernel; ``ref`` holds the plain versions."""
from __future__ import annotations

from repro_torch.kernels import ref  # noqa: F401  (re-exported for tests)
from repro_torch.kernels.reid_topk import (reid_topk_masked,  # noqa: F401
                                           reid_topk_segments,
                                           reid_topk_tiles)
