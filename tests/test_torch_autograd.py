"""Gradients at the hand-written kernels: CPU tensors keep their plain
versions' gradients (every input of ssd_scan's, flash_attention's), and
flash_attention's backward takes the views its 16-byte copies can read.
The card's half (the backward kernels through autograd) is in
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import gqa_flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan

pytestmark = pytest.mark.torch


def _leaf(*shape, seed=0):
    rng = np.random.default_rng([seed, *shape])
    return torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).requires_grad_()


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
    dt = torch.full((B, S, H), 0.1).requires_grad_()
    A = torch.tensor([-1.0, -0.5]).requires_grad_()
    D = torch.ones(H).requires_grad_()
    y, h = ssd_scan(xh, dt, A, Bc, Cc, D, chunk=8)
    (y.square().sum() + h.sum()).backward()
    for t in (xh, dt, A, Bc, Cc, D):
        assert t.grad is not None and torch.isfinite(t.grad).all()
        assert t.grad.shape == t.shape and t.grad.abs().sum() > 0


def test_backward_layout_follows_alignment():
    """The backward reads views by TMA tensor maps (bf16) or 16-byte copies
    (fp32): it takes 16-byte aligned views whose strides are multiples of
    16 bytes and not 0, and names what a view lacks; a stride on an axis of
    length 1 never counts (autograd hands a [1, S, H, D] gradient a batch
    stride of 1)."""
    from repro_torch.kernels.flash_attention import flash_attention as K

    t = torch.zeros((2, 64, 4, 128), dtype=torch.bfloat16)
    assert K.bwd_layout_fault(t) is None
    assert K.bwd_layout_fault(t[:, :, :2]) is None
    assert K.bwd_layout_fault(t.float()) is None
    assert "16-byte aligned" in K.bwd_layout_fault(
        t.view(-1)[1:].view(-1)[:2 * 64 * 4 * 127]
        .view(2, 64, 4, 127)[..., :64])
    one = torch.zeros((1, 64, 4, 128), dtype=torch.bfloat16).as_strided(
        (1, 64, 4, 128), (1, 512, 128, 1))
    assert K.bwd_layout_fault(one) is None
    assert "16-byte aligned" in K.bwd_layout_fault(t[:, :, :, 4:68])
    assert "multiples of 4" in K.bwd_layout_fault(
        torch.zeros((1, 64, 3, 66))[..., :64])
    assert "contiguous" in K.bwd_layout_fault(t.transpose(2, 3))
    assert "stride 0" in K.bwd_layout_fault(t[:, :1].expand(2, 64, 4, 128))
    assert K.bwd_layout_fault(t[:, :, :1].expand(2, 64, 1, 128)) is None
    assert K.bwd_key_tile(torch.bfloat16) == 64
    assert K.bwd_key_tile(torch.float32) == 32
    assert K.kv_splits(1, 1, 4096, 8, 132, 64) == 8        # gemma-2b, bf16
    assert K.kv_splits(1, 1, 4096, 8, 132, 32) == 4        # gemma-2b
    assert K.kv_splits(1, 8, 8192, 2, 132, 32) == 1        # gemma2-9b
