"""The port's SSD scan on the CPU (its plain torch version, which is what the
front end runs for CPU tensors) against the JAX package's Pallas kernel in
interpret mode and its ``ssd_ref`` oracle, on the same numpy inputs: the
sweep of ``tests/test_kernels.py`` (three fp32 shapes at a relative 1e-5 on
y and h_final, and its bf16 case at 5e-2), an independent float64 oracle
(the per-step recurrence), the output dtypes and the chunk check.  Then the
plain versions of the bf16 kernel's three passes (``ref.chunk_state``,
``state_pass``, ``chunk_out``), composed, against the same oracles; their
bf16 operand rounding against fp32; and the wrapper's choice of path and
its scratch shapes, which are pure Python.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref
from repro_torch.kernels.ssd_scan import launches, reset_launches, ssd_scan
from repro_torch.kernels.ssd_scan.ref import (
    chunk_out, chunk_state, ssd_passes, state_pass,
)
from repro_torch.kernels.ssd_scan.ssd_scan import scratch_shapes, wgmma_path
from repro_torch.models import ssd_chunked

pytestmark = pytest.mark.torch

#: (B, S, H, P, N, chunk): tests/test_kernels.py's sweep
SHAPES = [(1, 64, 2, 8, 16, 16), (2, 128, 3, 8, 16, 32),
          (1, 256, 4, 16, 32, 64)]


def _draw(shape, seed=0):
    """test_kernels.py's distribution: x, B, C, D ~ N(0, 1), dt in
    [0.01, 0.2], A in [-2, -0.5]."""
    Bn, S, H, P, N, _ = shape
    rng = np.random.default_rng([seed, *shape])
    return [rng.normal(size=(Bn, S, H, P)).astype(np.float32),
            rng.uniform(0.01, 0.2, size=(Bn, S, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32),
            rng.normal(size=(Bn, S, N)).astype(np.float32),
            rng.normal(size=(Bn, S, N)).astype(np.float32),
            rng.normal(size=(H,)).astype(np.float32)]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def recurrence(xh, dt, A, Bc, Cc, D):
    """h_t = exp(dt_t A) h_{t-1} + dt_t x_t (x) B_t, y_t = C_t . h_t +
    D x_t, step by step in float64."""
    xh, dt, A, Bc, Cc, D = (np.asarray(a, np.float64)
                            for a in (xh, dt, A, Bc, Cc, D))
    Bn, S, H, P = xh.shape
    h = np.zeros((Bn, H, P, Bc.shape[-1]))
    y = np.empty_like(xh)
    for t in range(S):
        h = np.exp(dt[:, t] * A)[..., None, None] * h + np.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], xh[:, t], Bc[:, t])
        y[:, t] = np.einsum("bn,bhpn->bhp", Cc[:, t], h) + \
            xh[:, t] * D[None, :, None]
    return y, h


@pytest.mark.parametrize("oracle", ["pallas", "ssd_ref"])
@pytest.mark.parametrize("shape", SHAPES)
def test_fp32_matches_jax(shape, oracle):
    arrs = _draw(shape)
    chunk = shape[-1]
    jargs = [jnp.asarray(a) for a in arrs]
    if oracle == "pallas":
        want_y, want_h = jax_ssd_scan(*jargs, chunk=chunk)
    else:
        want_y, want_h = jax_ssd_ref(*jargs, chunk)
    reset_launches()
    y, h = ssd_scan(*map(torch.from_numpy, arrs), chunk=chunk)
    assert launches == {"ssd_scan": 0}
    assert _rel(_np(y), _np(want_y)) < 1e-5
    assert _rel(_np(h), _np(want_h)) < 1e-5


@pytest.mark.parametrize("shape", SHAPES)
def test_fp32_matches_the_float64_recurrence(shape):
    arrs = _draw(shape, seed=1)
    y, h = ssd_scan(*map(torch.from_numpy, arrs), chunk=shape[-1])
    want_y, want_h = recurrence(*arrs)
    assert _rel(_np(y), want_y) < 1e-5
    assert _rel(_np(h), want_h) < 1e-5


@pytest.mark.parametrize("oracle", ["pallas", "ssd_ref_fp32"])
def test_bf16_within_tolerance(oracle):
    """test_kernels.py's bf16 case: bf16 inputs (A and D rounded to bf16
    for the scan under test) against the fp32 oracle on the upcast inputs,
    and against the Pallas kernel on the same bf16 inputs; 5e-2 relative
    on y and h_final."""
    shape = (1, 64, 2, 8, 16, 16)
    xh, dt, A, Bc, Cc, D = _draw(shape, seed=2)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (xh, dt, A, Bc, Cc, D)]
    if oracle == "pallas":
        want_y, want_h = jax_ssd_scan(*jb, chunk=16)
    else:
        up = [b.astype(jnp.float32) for b in jb]
        up[2], up[5] = jnp.asarray(A), jnp.asarray(D)
        want_y, want_h = jax_ssd_ref(*up, 16)
    tb = [torch.from_numpy(np.array(b.astype(jnp.float32))).bfloat16()
          for b in jb]
    y, h = ssd_scan(*tb, chunk=16)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert _rel(_np(y), _np(want_y)) < 5e-2
    assert _rel(_np(h), _np(want_h)) < 5e-2


def test_strided_view_of_the_conv_output():
    """xh as the [B,S,H,P] view of a [B,S,H*P] tensor, as ssm_forward
    passes it, and dt as a strided slice: the same result as contiguous
    copies."""
    shape = (2, 64, 4, 8, 16, 16)
    xh, dt, A, Bc, Cc, D = map(torch.from_numpy, _draw(shape, seed=3))
    flat = xh.reshape(2, 64, 32)
    dt_wide = torch.cat([dt, dt], dim=-1)[..., :4]
    assert not dt_wide.is_contiguous()
    got = ssd_scan(flat.view(2, 64, 4, 8), dt_wide, A, Bc, Cc, D, chunk=16)
    want = ssd_scan(xh, dt, A, Bc, Cc, D, chunk=16)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_output_dtypes(dtype):
    shape = (1, 32, 2, 8, 16, 16)
    arrs = [torch.from_numpy(a).to(dtype) for a in _draw(shape)]
    y, h = ssd_scan(*arrs, chunk=16)
    assert y.dtype == dtype and y.shape == (1, 32, 2, 8)
    assert h.dtype == torch.float32 and h.shape == (1, 2, 8, 16)


def test_sequence_not_a_multiple_of_the_chunk_raises():
    arrs = [torch.from_numpy(a) for a in _draw((1, 48, 2, 8, 16, 32))]
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_scan(*arrs, chunk=32)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_chunked(*arrs, 32)


def test_other_devices_raise():
    arrs = [torch.from_numpy(a).to("meta")
            for a in _draw((1, 32, 2, 8, 16, 16))]
    with pytest.raises(ValueError, match="cuda or cpu"):
        ssd_scan(*arrs, chunk=16)


# ---------------------------------------------------------------------------
# the passes of the bf16 kernel (csrc/ssd_passes.cu), in plain torch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("oracle", ["pallas", "ssd_ref"])
@pytest.mark.parametrize("shape", SHAPES)
def test_passes_compose_to_the_jax_scan(shape, oracle):
    """chunk_state, state_pass and chunk_out composed, in fp32, against
    the Pallas kernel (interpret mode) and ssd_ref at test_kernels.py's
    shapes: 1e-5 relative on y and h_final."""
    arrs = _draw(shape, seed=5)
    chunk = shape[-1]
    jargs = [jnp.asarray(a) for a in arrs]
    if oracle == "pallas":
        want_y, want_h = jax_ssd_scan(*jargs, chunk=chunk)
    else:
        want_y, want_h = jax_ssd_ref(*jargs, chunk)
    y, h = ssd_passes(*map(torch.from_numpy, arrs), chunk)
    assert _rel(_np(y), _np(want_y)) < 1e-5
    assert _rel(_np(h), _np(want_h)) < 1e-5


@pytest.mark.parametrize("shape", SHAPES)
def test_pass_outputs_match_the_chunked_scan(shape):
    """Each pass's output where ssd_chunked has it too: the last chunk
    state carried by state_pass is ssd_chunked's final state, and chunk_out
    given the h_before of state_pass is its y."""
    xh, dt, A, Bc, Cc, D = map(torch.from_numpy, _draw(shape, seed=6))
    chunk = shape[-1]
    states, chunk_sum = chunk_state(xh, dt, A, Bc, chunk)
    B_, S, H, P = xh.shape
    assert states.shape == (B_, S // chunk, H, P, Bc.shape[-1])
    assert chunk_sum.shape == (B_, H, S // chunk)
    np.testing.assert_allclose(
        chunk_sum.numpy(), (dt * A).reshape(B_, S // chunk, chunk, H)
        .sum(2).permute(0, 2, 1).numpy(), rtol=1e-5, atol=1e-6)
    h_before, h_final = state_pass(states, chunk_sum)
    assert torch.equal(h_before[:, 0], torch.zeros_like(h_before[:, 0]))
    want_y, want_h = ssd_chunked(xh, dt, A, Bc, Cc, D, chunk)
    assert _rel(h_final.numpy(), want_h.numpy()) < 1e-5
    y = chunk_out(xh, dt, A, Bc, Cc, D, h_before, chunk)
    assert _rel(y.numpy(), want_y.numpy()) < 1e-5


@pytest.mark.parametrize("shape", [(1, 256, 4, 16, 32, 64),
                                   (2, 512, 3, 64, 128, 256)])
def test_bf16_operand_rounding_within_tolerance(shape):
    """The bf16 kernel's roundings (x exp(acs_end - acs) dt, B, C, x,
    h_before and the scores to bf16; sums in fp32), emulated on bf16
    inputs, against the fp32 oracle on the same upcast inputs: within
    test_kernels.py's 5e-2 on y and h_final."""
    arrs = [torch.from_numpy(a).bfloat16() for a in _draw(shape, seed=7)]
    chunk = shape[-1]
    up = [a.float() for a in arrs]
    want_y, want_h = jax_ssd_ref(*(jnp.asarray(a.numpy()) for a in up),
                                 chunk)
    y, h = ssd_passes(*up, chunk, operand_dtype=torch.bfloat16)
    ry, rh = _rel(_np(y), _np(want_y)), _rel(_np(h), _np(want_h))
    assert ry < 5e-2 and rh < 5e-2
    y32, h32 = ssd_passes(*up, chunk)     # the rounding is what differs
    assert ry > _rel(_np(y32), _np(want_y))


def _main_widths(S=256, dtype=torch.bfloat16, P=64, N=128):
    """mamba2-780m's widths (48 heads), xh as the [B,S,H,P] view of the
    conv output [B,S,H*P], as ssm_forward passes it."""
    return (torch.zeros((1, S, 48 * P), dtype=dtype).view(1, S, 48, P),
            torch.zeros((1, S, N), dtype=dtype),
            torch.zeros((1, S, N), dtype=dtype))


@pytest.mark.parametrize("case,want", [
    ("main path", "wgmma"), ("chunk 64", "wgmma"), ("chunk 128", "wgmma"),
    ("fp32", "simple"), ("P 16", "simple"), ("N 16", "simple"),
    ("chunk 8", "simple"), ("chunk 512", "simple"),
    ("unaligned start", "simple"), ("row stride 4", "simple"),
    ("broadcast B", "simple"), ("strided x view", "wgmma"),
    ("empty sequence", "simple"),
])
def test_wrapper_path_choice(case, want):
    """wgmma_path: the Hopper passes take bf16 at P 64, N 128, a chunk
    that is a multiple of 64 up to 256, with TMA-aligned views; all else
    goes to the simple kernel.  Pure Python, on CPU tensors."""
    xh, Bc, Cc = _main_widths()
    chunk = 256
    if case.startswith("chunk"):
        chunk = int(case.split()[1])
        if chunk == 512:
            xh, Bc, Cc = _main_widths(S=512)
    elif case == "fp32":
        xh, Bc, Cc = _main_widths(dtype=torch.float32)
    elif case == "P 16":
        xh, Bc, Cc = _main_widths(P=16)
    elif case == "N 16":
        xh, Bc, Cc = _main_widths(N=16)
    elif case == "unaligned start":
        wide = torch.zeros((1, 256, 48 * 64 + 2), dtype=torch.bfloat16)
        xh = wide[..., 2:].view(1, 256, 48, 64)
        assert xh.data_ptr() % 16
    elif case == "row stride 4":
        Bc = torch.zeros((1, 256, 132), dtype=torch.bfloat16)[..., :128]
    elif case == "broadcast B":
        Bc = torch.zeros((1, 1, 128), dtype=torch.bfloat16).expand(1, 256,
                                                                   128)
    elif case == "empty sequence":
        xh, Bc, Cc = _main_widths(S=0)
    elif case == "strided x view":    # x, B and C sliced from one buffer
        flat = torch.zeros((1, 256, 48 * 64 + 256), dtype=torch.bfloat16)
        xh = flat[..., :48 * 64].view(1, 256, 48, 64)
        Bc, Cc = flat[..., 48 * 64:48 * 64 + 128], flat[..., 48 * 64 + 128:]
        assert not xh.is_contiguous()
    assert wgmma_path(xh, Bc, Cc, chunk) == want


def test_scratch_shapes():
    """The wgmma path's scratch at the main path [4, 32768]: fp32 chunk
    states and bf16 states before each chunk, [B, nc, H, P, N], and the
    fp32 chunk totals [B, H, nc]; 1.21 GB in all."""
    got = scratch_shapes(4, 32768, 48, 64, 128, 256)
    assert got == {"states": ((4, 128, 48, 64, 128), torch.float32),
                   "chunk_sum": ((4, 48, 128), torch.float32),
                   "h_before": ((4, 128, 48, 64, 128), torch.bfloat16)}
    nbytes = sum(np.prod(shape) * dtype.itemsize
                 for shape, dtype in got.values())
    assert nbytes == 4 * 128 * 48 * (64 * 128 * 6 + 4)
