"""Edge cases of ``gumbel_argmax``'s reduction over vocabulary slices.

One list, shared by ``test_torch_prng.py`` (the plain version against
``jax.random.categorical`` on the CPU), ``test_torch_gumbel_card.py`` (the
kernel against the plain version on a card, bit for bit) and
``chip_smoke.py``'s ``[prng]``.  Nothing here imports jax.

Widths around the kernel's slice (``GUMBEL_SLICE`` entries a block) at 1, 4
and 5 rows, and rows of the patterns that cross slices: an exact tie, a NaN
after a large entry, two NaNs, a row of ``-inf``.  In the patterns every
other entry is -1e30 and the marked ones +1e30, so the noise (|g| < 20)
cannot move the order among them.
"""

from __future__ import annotations

import numpy as np

from repro_torch.kernels.threefry import GUMBEL_SLICE

S = GUMBEL_SLICE
#: the key every case is sampled under, and the temperatures it is divided by.
SEED = 3
TEMPERATURES = (0.7, 1.0)
VOCABS = tuple(sorted({1, 33, 1023, 1025, 4097, S - 1, S, S + 1, 2 * S - 1, 2 * S + 1}))
ROWS = (1, 4, 5)
#: the width and row count of the cross-slice patterns.
PATTERN_SHAPE = (5, 3 * S + 5)
#: the shapes the paths launch at: RWKV6-1.6B's and Qwen3-8B's decode batch
#: of 4, and a wide batch.
PATH_SHAPES = ((4, 65_536), (4, 151_936), (64, 151_936))


def _pattern(name: str) -> tuple[np.ndarray, int]:
    logits = np.full(PATTERN_SHAPE, -1e30, np.float32)
    if name == "tie_across_slices":
        logits[:, [5, S + 7]] = 1e30
        return logits, 5
    if name == "nan_after_max":
        logits[:, 3] = 1e30
        logits[:, 2 * S + 1] = np.nan
        return logits, 2 * S + 1
    if name == "two_nans":
        logits[:, 0] = 1e30
        logits[:, [S + 2, 3 * S + 1]] = np.nan
        return logits, S + 2
    if name == "all_neg_inf":
        return np.full(PATTERN_SHAPE, -np.inf, np.float32), 0
    raise KeyError(name)


PATTERNS = ("tie_across_slices", "nan_after_max", "two_nans", "all_neg_inf")
#: every case by name: ``{rows}x{vocab}`` (normal logits times 3) and the patterns.
NAMES = tuple(f"{r}x{v}" for v in VOCABS for r in ROWS) + PATTERNS


def case(name: str) -> tuple[np.ndarray, int | None]:
    """(logits f32 (B, V), the token every row must take or None)."""
    if name in PATTERNS:
        return _pattern(name)
    rows, vocab = map(int, name.split("x"))
    rng = np.random.default_rng(rows * 100_003 + vocab)
    return (rng.standard_normal((rows, vocab)) * 3).astype(np.float32), None


def path_logits(rows: int, vocab: int) -> np.ndarray:
    """Logits at a path's shape: normal times 4, from the shape."""
    rng = np.random.default_rng(rows * 1_000_003 + vocab)
    return (rng.standard_normal((rows, vocab), dtype=np.float32) * 4).astype(np.float32)
