"""Gradients at the hand-written kernels: the card's path raises in
``backward`` (no backward kernel exists yet, ROADMAP.md Queue 1 item 7.1),
CPU tensors keep their plain versions' gradients, and ``torch.no_grad``
calls go straight to the kernel.  The card's half is in
tests/test_torch_cuda.py; here ``forward_only`` wraps plain functions.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.autograd import forward_only
from repro_torch.kernels.flash_attention import gqa_flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan

pytestmark = pytest.mark.torch


def _leaf(*shape, seed=0):
    rng = np.random.default_rng([seed, *shape])
    return torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).requires_grad_()


def test_forward_only_backward_raises_naming_the_roadmap():
    x = _leaf(3, 4)
    y = forward_only("k", lambda t: t.detach() * 2, x)
    assert y.grad_fn is not None
    torch.testing.assert_close(y.detach(), x.detach() * 2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 7.1"):
        y.sum().backward()


def test_forward_only_tuple_outputs_raise_too():
    x = _leaf(5)
    a, b = forward_only("k", lambda t: (t.detach() + 1, t.detach() - 1), x)
    with pytest.raises(NotImplementedError, match="k: the CUDA kernel"):
        (a * b).sum().backward()


def test_forward_only_calls_through_without_grad():
    x = _leaf(2, 2)
    calls = []

    def fn(t):
        calls.append(torch.is_grad_enabled())
        return t.detach() + 1

    with torch.no_grad():
        y = forward_only("k", fn, x)
    assert y.grad_fn is None and calls == [False]
    y = forward_only("k", fn, x.detach())        # no input needs a grad
    assert y.grad_fn is None and calls == [False, True]


def test_cpu_flash_attention_keeps_its_gradient():
    q, k, v = _leaf(1, 32, 4, 16), _leaf(1, 32, 2, 16, seed=1), \
        _leaf(1, 32, 2, 16, seed=2)
    out = gqa_flash_attention(q, k, v, causal=True, softcap=30.0)
    out.square().sum().backward()
    for t in (q, k, v):
        assert t.grad is not None and torch.isfinite(t.grad).all()
        assert t.grad.abs().sum() > 0


def test_cpu_ssd_scan_keeps_its_gradient():
    B, S, H, P, N = 1, 16, 2, 4, 4
    xh, Bc, Cc = _leaf(B, S, H, P), _leaf(B, S, N, seed=1), \
        _leaf(B, S, N, seed=2)
    dt = torch.full((B, S, H), 0.1)
    A = torch.tensor([-1.0, -0.5])
    D = torch.ones(H)
    y, h = ssd_scan(xh, dt, A, Bc, Cc, D, chunk=8)
    (y.square().sum() + h.sum()).backward()
    for t in (xh, Bc, Cc):
        assert t.grad is not None and torch.isfinite(t.grad).all()
