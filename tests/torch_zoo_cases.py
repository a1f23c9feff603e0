"""Shared pieces of the VLM and audio zoo differentials
(``test_torch_models_vlm.py``, ``test_torch_models_audio.py``)."""
import numpy as np
import torch

#: the bias leaves of the reference's tree, all zero at its init: the
#: attention's and the cross attention's ``bq``, ``bk``, ``bv``, the
#: MLP's ``bi`` and ``bo`` and the LayerNorms' ``bias``
BIASES = ("bq", "bk", "bv", "bi", "bo", "bias")


def nonzero_biases(tree: dict, seed: int) -> dict:
    """The reference's parameter tree (numpy) with every bias drawn from
    a normal x 0.5 seeded with ``seed`` (the seeds of
    ``scripts/torch_models_gap.py``, which measured the tolerances on
    such trees): a port that dropped a bias, or added one where the
    reference adds none, would then part from the reference."""
    rng = np.random.default_rng(1000 + seed)

    def walk(t, name=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        a = np.asarray(t)
        if name in BIASES:
            return (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return walk(tree)


def close(got, want, tol, what):
    """``|got - want| <= tol * (1 + |want|)`` elementwise, in float32."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)
