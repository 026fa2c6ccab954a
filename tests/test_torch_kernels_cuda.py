"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.  Every test is marked ``cuda`` and skips without a
CUDA device (a CUDA kernel has no CPU mode).  The file imports neither JAX
nor the JAX package, so on the card machine it runs with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

(tests/conftest.py imports JAX, which that machine does not have).

Tolerance 1e-4: float32 against float32 with another summation order;
the errors measured on an H100 are below 5e-7.
"""

import pytest
import torch

from ensemble_svs_with_interactions_tpu_torch.ops.lstm_recurrence import (
    lstm_recurrence,
    lstm_recurrence_reference,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H", [
    (4, 333, 62), (4, 333, 64), (4, 333, 256), (4, 333, 512),  # the path
    (1, 1, 8), (5, 37, 8),  # one block, batch groups of 4 and a ragged one
    (9, 41, 100), (3, 29, 1024),  # multi-block with a ragged last block
])
def test_lstm_recurrence_kernel_matches_plain(cuda, B, T, H):
    g = torch.Generator(device=cuda).manual_seed(B * 1000 + H)
    xw = torch.randn(B, T, 4 * H, device=cuda, generator=g)
    w_h = torch.randn(H, 4 * H, device=cuda, generator=g) / H ** 0.5
    before = lstm_recurrence.launches
    y, c = lstm_recurrence(xw, w_h, want_c=True)
    y_only = lstm_recurrence(xw, w_h)
    y_ref, c_ref = lstm_recurrence_reference(xw, w_h, want_c=True)
    torch.cuda.synchronize()
    assert lstm_recurrence.launches == before + 2
    assert (y - y_ref).abs().max().item() < 1e-4
    assert (c - c_ref).abs().max().item() < 1e-4
    assert torch.equal(y, y_only)


@pytest.mark.cuda
def test_lstm_recurrence_rejects_what_the_kernel_does_not_take(cuda):
    xw = torch.randn(2, 5, 32, device=cuda)
    w_h = torch.randn(8, 32, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        lstm_recurrence(xw.double(), w_h.double())
    with pytest.raises(ValueError, match="contiguous"):
        lstm_recurrence(xw.transpose(0, 1), w_h)
    with pytest.raises(ValueError, match="do not form"):
        lstm_recurrence(xw, w_h[:, :16])
