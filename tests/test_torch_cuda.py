"""The additive-pool CUDA kernel on the card (skips without one).

Imports no JAX, so that it runs on a machine with the card but without
JAX: `python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`.
The kernel is held against its plain version at small, odd shapes (L not
a multiple of the register tile, H below and above the block width) with
f32 inputs within 1e-5 (values O(1), sums in another order), and every
input the wrapper refuses must raise before a launch.
"""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from legommenders_tpu_torch.ops.additive import (  # noqa: E402
    additive_pool, additive_pool_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(N, L, D, H, device, dtype=torch.float32):
    g = torch.Generator(device=device).manual_seed(N + L + D + H)
    x = torch.randn(N, L, D, generator=g, device=device).to(dtype)
    mask = (torch.rand(N, L, generator=g, device=device) < 0.7).float()
    mask[0] = 0.0
    w1 = torch.randn(D, H, generator=g, device=device) / D ** 0.5
    b1 = torch.randn(H, generator=g, device=device) * 0.1
    w2 = torch.randn(H, generator=g, device=device) / H ** 0.5
    return x, mask, w1, b1, w2


@pytest.mark.parametrize("N,L,D,H", [(37, 13, 16, 32), (300, 50, 64, 256),
                                     (5, 1, 8, 300)])
def test_kernel_matches_plain(device, N, L, D, H):
    args = _inputs(N, L, D, H, device)
    before = additive_pool.launches
    with torch.no_grad():
        got = additive_pool(*args)
        want = additive_pool_reference(*args)
    torch.cuda.synchronize()
    assert additive_pool.launches == before + 1
    assert (got - want).abs().max().item() <= 1e-5
    assert (got[0] == 0).all()


def test_kernel_bf16_output(device):
    args = _inputs(64, 31, 64, 256, device, torch.bfloat16)
    with torch.no_grad():
        got = additive_pool(*args)
        want = additive_pool_reference(args[0].float(), *args[1:])
    assert got.dtype == torch.bfloat16
    err = (got.float() - want).abs().max() / want.abs().max()
    assert err.item() <= 2e-2


def test_wrapper_refuses(device):
    x, mask, w1, b1, w2 = _inputs(8, 5, 16, 32, device)
    with pytest.raises(ValueError, match="contiguous"):
        additive_pool(x.transpose(0, 1), mask, w1, b1, w2)
    with pytest.raises(TypeError, match="dtype"):
        additive_pool(x.half(), mask, w1, b1, w2)
    with pytest.raises(ValueError, match="shape"):
        additive_pool(x, mask[:, :4], w1, b1, w2)
    with pytest.raises(ValueError, match="multiple of 4"):
        additive_pool(x[..., :6].contiguous(), mask, w1[:6], b1, w2)
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros(1, 8, 256, device=device)
        additive_pool(big, torch.ones(1, 8, device=device),
                      torch.zeros(256, 1024, device=device),
                      torch.zeros(1024, device=device),
                      torch.zeros(1024, device=device))
    w1.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        additive_pool(x, mask, w1, b1, w2)
    with pytest.raises(ValueError, match="on cpu"):
        additive_pool(x, mask.cpu(), w1.detach(), b1, w2)
