"""Train a small analytics backbone (the yi-6b family scaled to d_model
384 and 6 layers) for a few hundred steps, through
``repro_torch.launch.train`` with the flags of the JAX package's
``examples/train_backbone.py``; on the card by default.

  PYTHONPATH=src python -m repro_torch.examples.train_backbone [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.launch.train import main as train_main


def main(device: str = "cuda", ckpt: str | None = None) -> None:
    ckpt = ckpt or os.path.join(tempfile.gettempdir(),
                                "repro_torch_train_demo")
    train_main(["--arch", "yi_6b", "--steps", "200", "--d-model", "384",
                "--layers", "6", "--seq", "256", "--batch", "8",
                "--ckpt", ckpt, "--device", device])


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default=None)
    main(**vars(ap.parse_args()))
