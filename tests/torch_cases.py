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


TILE_CASES = [
    # (Q, G, D, C, T, k, options): CT = C*T*T cells
    (33, 517, 16, 8, 4, 3, dict(masked_row=True, unlabeled=40)),
    (7, 70, 8, 5, 8, 16, {}),
    (5, 3, 8, 4, 2, 8, {}),                    # k > G: sentinel tail
    (24, 90, 8, 3, 4, 4, dict(ties=True, unlabeled=9)),
    (12, 200, 8, 130, 8, 5, dict(ties=True, n_tags=1, unlabeled=15)),
    (1, 1, 4, 2, 2, 1, {}),
]


def make_tile_inputs(seed, Q, G, D, C, T, *, ties=False, n_tags=3,
                     masked_row=False, unlabeled=0, out_of_range=0,
                     p_admit=0.6):
    """(queries, q_tag, admit_ct, gallery, gal_ct, gal_tag) as numpy arrays
    over CT = C*T*T fused cells; ``unlabeled`` rows carry cell -1 and
    ``out_of_range`` rows a cell in [CT, CT + 64)."""
    rng = np.random.default_rng(seed)
    CT = C * T * T
    draw = (lambda s: rng.integers(0, 2, s).astype(np.float32)) if ties \
        else (lambda s: rng.normal(size=s).astype(np.float32))
    qf, gf = draw((Q, D)), draw((G, D))
    q_tag = rng.integers(0, n_tags, Q).astype(np.int32)
    gal_tag = rng.integers(0, n_tags, G).astype(np.int32)
    admit_ct = rng.random((Q, CT)) < p_admit
    gal_ct = rng.integers(0, CT, G).astype(np.int32)
    if masked_row:
        admit_ct[0] = False
    rows = rng.permutation(G)
    gal_ct[rows[:unlabeled]] = -1
    gal_ct[rows[unlabeled:unlabeled + out_of_range]] = rng.integers(
        CT, CT + 64, min(out_of_range, max(G - unlabeled, 0)))
    return qf, q_tag, admit_ct, gf, gal_ct, gal_tag


def camera_to_tiles(arrays, T, seed=0):
    """Camera-masked inputs -> the same problem over fused cells with every
    tile of an admitted camera admitted: ``admit_ct`` repeats each camera
    column T*T times and each row gets a random tile of its camera
    (cam -1 stays -1)."""
    qf, q_tag, admit, gf, gal_cam, gal_tag = arrays
    TT = T * T
    tile = np.random.default_rng(seed).integers(0, TT, len(gal_cam))
    gal_ct = np.where(gal_cam >= 0, gal_cam * TT + tile, -1).astype(np.int32)
    return qf, q_tag, np.repeat(admit, TT, axis=1), gf, gal_ct, gal_tag


# The kernel benchmark's four kernels: shapes from the JAX package's sweeps
# (``tests/test_kernels.py``) and its kernel audit, shared by the CPU
# differentials (``test_torch_bench_kernels.py``) and the card tests.

TOPK_CASES = [
    # (Q, G, D, k, ties)
    (64, 512, 64, 8, False),
    (33, 517, 16, 5, False),                   # ragged on both axes
    (7, 70, 8, 3, False),
    (1, 1, 64, 1, False),
    (40, 300, 16, 5, True),                    # integer-valued ties
    (5, 3, 16, 8, False),                      # k > G: sentinel tail
]

FLASH_CASES = [
    # (B, H, KV, S, T, hd, causal, bf16)
    (1, 4, 4, 128, 128, 64, True, False),      # MHA
    (1, 4, 4, 128, 128, 64, False, False),
    (2, 8, 2, 256, 256, 64, True, True),       # GQA
    (1, 16, 1, 128, 128, 128, False, False),   # MQA
    (1, 16, 1, 128, 128, 128, True, True),
    (2, 4, 4, 192, 192, 32, True, False),      # S not a power of two
    (2, 4, 2, 256, 512, 64, True, False),      # S != T (the kernel audit's)
    (1, 2, 2, 512, 256, 32, False, True),
]

DECODE_CASES = [
    # (B, H, KV, T, hd, bf16)
    (2, 8, 2, 512, 64, False),
    (2, 8, 2, 512, 64, True),
    (1, 4, 4, 1024, 128, False),
    (3, 16, 4, 256, 64, True),
    (2, 4, 1, 256, 32, False),                 # MQA
]

SCAN_CASES = [
    # (B, L, D, N)
    (2, 128, 64, 16),
    (1, 256, 128, 8),
    (2, 64, 32, 4),
]


def attention_tol(bf16):
    """The JAX sweep's attention tolerances: 2e-2 in bfloat16, 2e-5 in
    float32 (``tests/test_kernels.py``)."""
    return dict(rtol=2e-2, atol=2e-2) if bf16 else dict(rtol=2e-5, atol=2e-5)


def topk_inputs(seed, Q, G, D, ties=False):
    """(queries, gallery) float32; ``ties`` draws 0/1 features."""
    rng = np.random.default_rng(seed)
    if ties:
        return (rng.integers(0, 2, (Q, D)).astype(np.float32),
                rng.integers(0, 2, (G, D)).astype(np.float32))
    return (rng.normal(size=(Q, D)).astype(np.float32),
            rng.normal(size=(G, D)).astype(np.float32))


def attention_inputs(seed, B, H, KV, S, T, hd):
    """(q (B, H, S, hd), k, v (B, KV, T, hd)) float32 normals; S = 0 gives
    a decode query (B, H, hd)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, S, hd) if S else (B, H, hd))
    k, v = (rng.normal(size=(B, KV, T, hd)) for _ in range(2))
    return tuple(a.astype(np.float32) for a in (q, k, v))


def scan_inputs(seed, B, L, D, N):
    """(u, dt, Bm, Cm, A) float32, distributed as the JAX sweep's."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(B, L, D)) * 0.5
    dt = np.log1p(np.exp(rng.normal(size=(B, L, D)))) * 0.1
    Bm = rng.normal(size=(B, L, N)) * 0.5
    Cm = rng.normal(size=(B, L, N)) * 0.5
    A = -np.exp(rng.normal(size=(D, N)) * 0.3)
    return tuple(a.astype(np.float32) for a in (u, dt, Bm, Cm, A))
