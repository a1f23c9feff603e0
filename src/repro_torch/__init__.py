"""ReXCam on PyTorch and CUDA: the port of ``repro`` to one NVIDIA H100.

The layout mirrors ``repro`` (``core/``, ``kernels/``, ``runtime/``,
``launch/``, ``api.py``) so every module has a counterpart there.  Plain
array code is PyTorch; the TPU kernels on the serving path (the
segment-masked re-id top-k and its tile-masked variant) are hand-written
CUDA kernels, ``kernels/csrc/reid_topk.cu`` and
``kernels/csrc/reid_topk_tiles.cu``.  Entry points take ``device=``, default
``"cuda"``, and raise when no card is present unless given ``"cpu"``.
"""
