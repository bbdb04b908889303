"""``gumbel_argmax``'s kernel on a card, held bit for bit to its plain
version (``kernels.ref.gumbel_argmax_ref``, on the same card) on the edge
cases of ``gumbel_cases`` and at the shapes the paths launch it with, at
both temperatures.  Each call must count one launch, though it runs two
passes.  Without a card every case skips (decided inside the test); jax is
not imported (``test_torch_prng.py`` holds the plain version to jax on the
CPU, on the same cases).

    PYTHONPATH=src python3 -m pytest tests/test_torch_gumbel_card.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import gumbel_cases
from repro_torch import prng
from repro_torch.kernels import ref, threefry


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _hold(logits: np.ndarray, device: torch.device, token=None) -> None:
    key = prng.PRNGKey(gumbel_cases.SEED)
    x = torch.from_numpy(logits).to(device)
    for temperature in gumbel_cases.TEMPERATURES:
        scaled = x / torch.tensor(temperature, dtype=torch.float32, device=device)
        before = threefry.launches["gumbel_argmax"]
        got = threefry.gumbel_argmax(key, scaled)
        assert threefry.launches["gumbel_argmax"] == before + 1
        want = ref.gumbel_argmax_ref(key, scaled)
        torch.cuda.synchronize(device)
        assert got.dtype == torch.int64 and got.is_cuda
        assert torch.equal(got, want), (got.tolist(), want.tolist())
        if token is not None:
            assert got.tolist() == [token] * logits.shape[0]


@pytest.mark.parametrize("name", gumbel_cases.NAMES)
def test_kernel_edge_cases(card, name):
    logits, token = gumbel_cases.case(name)
    _hold(logits, card, token)


@pytest.mark.parametrize("shape", gumbel_cases.PATH_SHAPES + ((70_000, 33),),
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_at_path_shapes(card, shape):
    """The paths' shapes, and rows past the grid's 65,535 (pass 1 loops
    over them)."""
    _hold(gumbel_cases.path_logits(*shape), card)
