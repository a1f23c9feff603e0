"""Seeded inputs of the segment-masked re-id top-k, shared by the CPU
tests (``test_torch_kernels.py``) and the card tests
(``test_torch_cuda.py``).  Imports numpy only."""
import numpy as np

CASES = [
    # (Q, G, D, C, k, options)
    (33, 517, 16, 8, 3, dict(masked_row=True)),
    (7, 70, 8, 5, 16, {}),
    (5, 3, 8, 4, 8, {}),                       # k > G: sentinel tail
    (24, 90, 8, 3, 4, dict(ties=True)),        # integer-valued ties
    (12, 200, 8, 130, 5, dict(ties=True, n_tags=1)),
    (1, 1, 4, 2, 1, {}),
]


def make_inputs(seed, Q, G, D, C, *, ties=False, n_tags=3, masked_row=False,
                pad_rows=0):
    """(queries, q_tag, admit, gallery, gal_cam, gal_tag) as numpy arrays;
    ``ties`` draws 0/1 features so scores tie exactly, ``pad_rows`` gives
    the last rows cam -1 as the engine's padding does."""
    rng = np.random.default_rng(seed)
    draw = (lambda s: rng.integers(0, 2, s).astype(np.float32)) if ties \
        else (lambda s: rng.normal(size=s).astype(np.float32))
    qf, gf = draw((Q, D)), draw((G, D))
    q_tag = rng.integers(0, n_tags, Q).astype(np.int32)
    gal_tag = rng.integers(0, n_tags, G).astype(np.int32)
    admit = rng.random((Q, C)) < 0.6
    gal_cam = rng.integers(0, C, G).astype(np.int32)
    if masked_row:
        admit[0] = False
    if pad_rows:
        gal_cam[G - pad_rows:] = -1
    return qf, q_tag, admit, gf, gal_cam, gal_tag
