"""Serving engine demo: live camera streams through the ReXCam admission
filter into the batched ranking plane, on the card by default (see
``repro_torch/launch/serve.py`` for the full command line with its flags).

  PYTHONPATH=src python -m repro_torch.examples.serve_streams [--device cpu]

Prints the lines of the JAX package's ``examples/serve_streams.py``, with
the same counts, but for the device line and the host-clock wall line.
"""
from __future__ import annotations

import argparse

from repro_torch.launch.serve import main as serve_main


def main(device: str = "cuda") -> None:
    serve_main(["--queries", "6", "--steps", "400", "--device", device])


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    main(ap.parse_args().device)
