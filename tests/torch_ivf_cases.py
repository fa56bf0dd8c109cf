"""The per-probed-block IVF cases (``ivf_topk``, ``ivf_topk_int8``) that
the CPU parity tests (``tests/test_torch_topk_blocks.py``: the port's
plain versions against the JAX package's ``pallas_ivf_topk*`` in interpret
mode) and the GPU tests (``tests/test_torch_cuda.py``: the port's kernels
against those plain versions) share, and the inputs they draw. numpy only,
so the GPU tests run without JAX."""

import numpy as np

NEG_INF = float(np.finfo(np.float32).min)


def make_inputs(q, d, n, kind, seed=0):
    """Unit rows and queries, and a bias of one of these kinds:
    mixed: NEG_INF tombstones every 5th row, -inf every 13th from row 7;
    dead: three live rows (300, 301, 700), rows 0-2 -inf, the rest NEG_INF;
    allinf0: block 0 (rows 0-255) -inf, two live rows, the rest NEG_INF;
    allinf0-dead: no live row: rows 0-258 -inf, the rest NEG_INF (block 0
    of 256 rows scores -inf throughout, block 1's lowest column scoring
    NEG_INF is 3);
    none: every row NEG_INF;
    ties: every row live, rows 20, 300, 600 and 900 copy row 700, query 0
    is row 700."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    qs = rng.standard_normal((q, d)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    bias = np.zeros(n, np.float32)
    if kind == "mixed":
        bias[::5] = NEG_INF
        bias[7::13] = -np.inf
    elif kind == "dead":
        bias[:] = NEG_INF
        bias[:3] = -np.inf
        bias[[300, 301, 700]] = 0.0
    elif kind == "allinf0":
        bias[:] = NEG_INF
        bias[:256] = -np.inf
        bias[[400, 900]] = 0.0
    elif kind == "allinf0-dead":
        bias[:] = NEG_INF
        bias[:259] = -np.inf
    elif kind == "none":
        bias[:] = NEG_INF
    elif kind == "ties":
        x[[20, 300, 600, 900]] = x[700]
        qs[0] = x[700]
    return qs, x, bias


def _perm(n_blocks, m, seed):
    """m distinct block ids of n_blocks, shuffled."""
    return [int(b) for b in np.random.default_rng(seed).permutation(n_blocks)[:m]]


# name → (bias kind, ids, n_valid, block_rows, k, q, n); width 128
IVF_CASES = {
    "partial-ascending": ("mixed", [1, 2, 5, 0, 3, 4, 6, 7], 3, 128, 10, 3, 1024),
    "one-block": ("mixed", [6, 0, 1, 2, 3, 4, 5, 7], 1, 128, 10, 3, 1024),
    "empty-plan": ("mixed", [1, 2, 3, 0], 0, 256, 10, 3, 1024),
    "full-shuffled-k128": ("mixed", [2, 0, 3, 1], 4, 256, 128, 3, 1024),
    "dead-fill-ids0": ("dead", [1, 2, 3, 0], 2, 256, 10, 3, 1024),
    "dead-fill-shuffled": ("dead", [3, 1, 0, 0], 2, 256, 10, 3, 1024),
    "allinf-block0-k32": ("allinf0", [0, 1, 2, 3], 4, 256, 32, 3, 1024),
    "allinf-block0-k128": ("allinf0", [0, 1, 2, 3], 4, 256, 128, 3, 1024),
    "ties-probe-order": ("ties", [3, 1, 0, 2], 4, 256, 10, 3, 1024),
    # block_rows 4 and 12: a 32-row stage of the kernel spans several blocks
    "rows4-k4-shuffled": ("mixed", _perm(256, 96, 4), 48, 4, 4, 8, 1024),
    "rows4-k1-dead": ("dead", _perm(256, 80, 5), 80, 4, 1, 3, 1024),
    "rows4-ties-full": ("ties", _perm(256, 256, 6), 256, 4, 4, 3, 1024),
    "rows12-k12": ("mixed", _perm(85, 60, 7), 30, 12, 12, 8, 1020),
    "rows12-dead-k5": ("dead", _perm(85, 40, 8), 40, 12, 5, 3, 1020),
    # k = block_rows; duplicate ids past n_valid
    "k-is-block-rows": ("mixed", [2, 0, 3, 1], 2, 256, 256, 3, 1024),
    "duplicates-past-n-valid": ("dead", [5, 2, 2, 5, 2, 5], 2, 128, 10, 3, 1024),
    # no live row, position 0 scoring -inf throughout: at k = 128 the tail
    # walks on to position 1 (its c0, or 0 past n_valid), or with one listed
    # block ends in (-inf, base); at k = 10 it ends in the pad's (NEG_INF, 0)
    "allinf-block0-dead-k128": ("allinf0-dead", [0, 1, 2, 3], 4, 256, 128, 3, 1024),
    "allinf-block0-dead-nv1-k128": ("allinf0-dead", [0, 3, 1, 2], 1, 256, 128, 3, 1024),
    "allinf-block0-dead-single": ("allinf0-dead", [0], 1, 256, 128, 3, 1024),
    "allinf-block0-dead-k10": ("allinf0-dead", [0, 1, 2, 3], 4, 256, 10, 3, 1024),
    # the widest blocks, and query counts around the 8-query tiles and the
    # 64 of a launch
    "rows4096-q65-k129": ("mixed", [1, 0], 1, 4096, 129, 65, 8192),
    "q130-k129": ("mixed", [3, 0, 2, 1], 3, 256, 129, 130, 1024),
    "q64-k1": ("mixed", [3, 0, 2, 1], 4, 256, 1, 64, 1024),
    "q1-k10": ("mixed", [2, 0, 3, 1], 2, 256, 10, 1, 1024),
}

# Cases the GPU tests add: JAX's _select_topk unrolls its k passes, so at
# k = 1024 the interpret-mode kernel takes a minute to compile on the CPU
IVF_WIDE_CASES = {
    "rows4096-k1024": ("mixed", [1, 0], 2, 4096, 1024, 8, 8192),
    "rows4096-k4096-dead": ("dead", [1, 0], 2, 4096, 4096, 8, 8192),
    "rows1024-k1024-q65": ("mixed", _perm(8, 8, 9), 5, 1024, 1024, 65, 8192),
}
