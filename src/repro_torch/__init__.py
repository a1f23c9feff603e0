"""ReXCam on PyTorch and CUDA: the port of ``repro`` to one NVIDIA H100.

The layout mirrors ``repro`` (``core/``, ``kernels/``, ``runtime/``,
``launch/``, ``benchmarks/``, ``api.py``) so every module has a
counterpart there.  Plain array code is PyTorch; every TPU kernel of
``repro.kernels`` is a hand-written CUDA kernel under ``kernels/csrc/``:
the serving path's segment-masked re-id top-k and its tile-masked variant,
and the kernel benchmark's unmasked re-id top-k, flash attention, decode
attention and Mamba scan.  Entry points take ``device=``, default
``"cuda"``, and raise when no card is present unless given ``"cpu"``.
"""
