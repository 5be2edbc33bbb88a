"""The port's SSD scan on the CPU (its plain torch version, which is what the
front end runs for CPU tensors) against the JAX package's Pallas kernel in
interpret mode and its ``ssd_ref`` oracle, on the same numpy inputs: the
sweep of ``tests/test_kernels.py`` (three fp32 shapes at a relative 1e-5 on
y and h_final, and its bf16 case at 5e-2), an independent float64 oracle
(the per-step recurrence), the output dtypes and the chunk check.  Then the
plain versions of the bf16 kernel's three passes (``ref.chunk_state``,
``state_pass``, ``chunk_out``), composed, against the same oracles; their
bf16 operand rounding against fp32; and the wrapper's choice of path and
its scratch shapes, which are pure Python.  Last, the gradient: the port's
autograd through its plain version and the plain versions of the backward
kernel's four passes (``ref.ssd_passes_bwd``) against ``jax.vjp`` of the
JAX package's ``ssd_chunked`` with numpy cotangents for y and h_final;
each pass against autograd through the forward's passes; their bf16
operand rounding against fp32.  The bf16 backward on wgmma: its path
choice and scratch (pure Python), its plain passes (``ssd_passes_bwd(...,
path="wgmma")``, through ``chunk_bwd_summed``) against ``jax.vjp`` in fp32
and with its roundings, and the head-summed pass against the per-head one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd_scan import (
    bwd_launches, launches, reset_launches, ssd_scan,
)
from repro_torch.kernels.ssd_scan.ref import (
    chunk_bwd, chunk_bwd_summed, chunk_out, chunk_state, reduce_bwd,
    ssd_passes, ssd_passes_bwd, state_grad_from_y, state_pass,
    state_pass_bwd,
)
from repro_torch.kernels.ssd_scan.ssd_scan import (
    BWD_BUFFERS, BWD_WGMMA_BUFFERS, bwd_path, bwd_scratch_shapes, scan_bwd,
    scratch_shapes, wgmma_path,
)
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


class _OtherDevice(torch.Tensor):
    """A tensor that says it lies on a device that is neither the card,
    the CPU nor meta (the dry run's), and holds no data."""

    @staticmethod
    def __new__(cls, shape):
        return torch.Tensor._make_wrapper_subclass(
            cls, shape, dtype=torch.float32, device=torch.device("xpu"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError("no data")


def test_other_devices_raise():
    """A device other than cuda and cpu raises; meta tensors (the dry
    run's pricing) go to the plain version instead."""
    shapes = [a.shape for a in _draw((1, 32, 2, 8, 16, 16))]
    with pytest.raises(ValueError, match="cuda or cpu"):
        ssd_scan(*[_OtherDevice(s) for s in shapes], chunk=16)
    y, h = ssd_scan(*[torch.empty(s, device="meta") for s in shapes],
                    chunk=16)
    assert y.device.type == "meta" and y.shape == shapes[0]


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


# ---------------------------------------------------------------------------
# the gradient: autograd through the plain version and the backward's passes
# ---------------------------------------------------------------------------

#: relative error (max |got - want| / max |want|) of each fp32 gradient
GRAD_TOL = 1e-4
GRAD_NAMES = ("dxh", "ddt", "dA", "dBc", "dCc", "dD")


def _cotangents(shape, seed):
    """dy [B,S,H,P] and dh_final [B,H,P,N] ~ N(0, 1), drawn with numpy."""
    Bn, S, H, P, N, _ = shape
    rng = np.random.default_rng([seed, 99, *shape])
    return (rng.normal(size=(Bn, S, H, P)).astype(np.float32),
            rng.normal(size=(Bn, H, P, N)).astype(np.float32))


def _jax_vjp(arrs, dy, dh, chunk):
    """jax.vjp of the JAX package's ssd_chunked: the six gradients for the
    cotangents (dy, dh_final), a zero dh_final where ``dh`` is None."""
    _, vjp = jax.vjp(lambda *a: jax_ssd_chunked(*a, chunk),
                     *map(jnp.asarray, arrs))
    dh = np.zeros((dy.shape[0], dy.shape[2], dy.shape[3],
                   arrs[3].shape[-1]), np.float32) if dh is None else dh
    return vjp((jnp.asarray(dy), jnp.asarray(dh)))


def _assert_grads(got, want, tol=GRAD_TOL):
    for name, g, w in zip(GRAD_NAMES, got, want):
        assert tuple(g.shape) == np.shape(w), name
        assert _rel(_np(g), _np(w)) < tol, (name, _rel(_np(g), _np(w)))


@pytest.mark.parametrize("dh_final", ["zero", "random"])
@pytest.mark.parametrize("shape", SHAPES)
def test_autograd_through_the_plain_version_matches_jax_vjp(shape, dh_final):
    """The port's CPU path (autograd through ref.ssd_chunked, what
    ssd_scan runs for CPU tensors) against jax.vjp of the JAX package's
    ssd_chunked: every gradient to a relative 1e-4 in fp32.  A zero
    dh_final is the training path's (h_final unused)."""
    arrs = _draw(shape, seed=8)
    dy, dh = _cotangents(shape, seed=8)
    dh = None if dh_final == "zero" else dh
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrs]
    reset_launches()
    y, h = ssd_scan(*leaves, chunk=shape[-1])
    outs, cots = ((y,), (torch.from_numpy(dy),)) if dh is None else \
        ((y, h), (torch.from_numpy(dy), torch.from_numpy(dh)))
    got = torch.autograd.grad(outs, leaves, cots)
    assert launches == {"ssd_scan": 0} and bwd_launches == {"ssd_scan_bwd": 0}
    _assert_grads(got, _jax_vjp(arrs, dy, dh, shape[-1]))


@pytest.mark.parametrize("dh_final", ["zero", "random"])
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_passes_match_jax_vjp(shape, dh_final):
    """The plain versions of the backward kernel's passes, composed
    (ref.ssd_passes_bwd: dh_y, the reverse state pass, the chunks' local
    gradients, the sums over heads and chunks), against jax.vjp of the
    JAX package's ssd_chunked: every gradient to a relative 1e-4 in fp32,
    with dh_final None (zero) or random."""
    arrs = _draw(shape, seed=9)
    dy, dh = _cotangents(shape, seed=9)
    dh = None if dh_final == "zero" else dh
    got = ssd_passes_bwd(*map(torch.from_numpy, arrs), torch.from_numpy(dy),
                         None if dh is None else torch.from_numpy(dh),
                         shape[-1])
    assert all(g.dtype == torch.float32 for g in got)
    _assert_grads(got, _jax_vjp(arrs, dy, dh, shape[-1]))


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_state_passes_match_autograd_of_the_forward_passes(shape):
    """Passes (a) and (b) on their own: dh_y is the gradient of chunk_out's
    y with respect to its h_before, and the reverse state pass's dstates
    that of (y, h_final) with respect to chunk_state's chunk states,
    through state_pass and chunk_out (autograd, fp32, 1e-5 relative)."""
    xh, dt, A, Bc, Cc, D = map(torch.from_numpy, _draw(shape, seed=10))
    dy, dh = map(torch.from_numpy, _cotangents(shape, seed=10))
    chunk = shape[-1]
    states, chunk_sum = chunk_state(xh, dt, A, Bc, chunk)
    states.requires_grad_()
    h_before, h_final = state_pass(states, chunk_sum)
    y = chunk_out(xh, dt, A, Bc, Cc, D, h_before, chunk)
    want_dhy, = torch.autograd.grad(y, h_before, dy, retain_graph=True)
    want_dstates, = torch.autograd.grad((y, h_final), states, (dy, dh))
    dh_y, got_sum = state_grad_from_y(dy, dt, A, Cc, chunk)
    assert torch.equal(got_sum, chunk_sum)
    assert _rel(dh_y.numpy(), want_dhy.numpy()) < 1e-5
    dstates = state_pass_bwd(dh_y, chunk_sum, dh)
    assert _rel(dstates.numpy(), want_dstates.numpy()) < 1e-5
    assert torch.equal(dstates[:, -1], dh)        # the last chunk's is dh


@pytest.mark.parametrize("shape", [(1, 256, 4, 16, 32, 64),
                                   (2, 512, 3, 64, 128, 256)])
def test_bf16_backward_operand_rounding_within_tolerance(shape):
    """The backward's passes on bf16 inputs with the bf16 kernel's
    rounding (the forward's chunk states from bf16 operands, then each
    gradient rounded to bf16 as the kernel writes it) against jax.vjp of
    the fp32 oracle on the same upcast inputs: within test_kernels.py's
    5e-2 on every gradient.  The rounding is what differs from fp32."""
    arrs = [torch.from_numpy(a).bfloat16() for a in _draw(shape, seed=11)]
    dy, dh = _cotangents(shape, seed=11)
    dy16 = torch.from_numpy(dy).bfloat16()
    up = [a.float() for a in arrs]
    want = _jax_vjp([a.numpy() for a in up], dy16.float().numpy(), dh,
                    shape[-1])
    got = ssd_passes_bwd(*arrs, dy16, torch.from_numpy(dh), shape[-1],
                         operand_dtype=torch.bfloat16)
    assert all(g.dtype == torch.bfloat16 for g in got)
    _assert_grads(got, want, tol=5e-2)
    got32 = ssd_passes_bwd(*up, dy16.float(), torch.from_numpy(dh),
                           shape[-1])
    _assert_grads(got32, want)
    assert max(_rel(_np(g), _np(w)) for g, w in zip(got, want)) > \
        max(_rel(_np(g), _np(w)) for g, w in zip(got32, want))


def test_gradient_stays_finite_where_the_decay_overflows():
    """A chunk of 256 whose total log decay reaches -128 (dt 0.5, A -1):
    exp(acs_t - acs_s) above the diagonal overflows fp32.  The port's
    autograd through its plain version stays finite (it takes exp of the
    masked difference only; the JAX function's gradient is NaN there) and
    equals the backward's passes, which never form those entries."""
    shape = (1, 512, 2, 8, 16, 256)
    xh, _, _, Bc, Cc, D = _draw(shape, seed=12)
    dt = np.full((1, 512, 2), 0.5, np.float32)
    A = np.full((2,), -1.0, np.float32)
    arrs = [xh, dt, A, Bc, Cc, D]
    dy, dh = _cotangents(shape, seed=12)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrs]
    y, h = ssd_scan(*leaves, chunk=256)
    got = torch.autograd.grad((y, h), leaves, (torch.from_numpy(dy),
                                               torch.from_numpy(dh)))
    assert all(torch.isfinite(g).all() for g in got)
    want = ssd_passes_bwd(*map(torch.from_numpy, arrs), torch.from_numpy(dy),
                          torch.from_numpy(dh), 256)
    _assert_grads(got, want)


def test_gradient_at_mamba2_init_where_the_references_is_nan():
    """mamba2-780m's initial A and dt (the JAX package's init_ssm_params at
    its full width: A = -(1..48), dt = softplus(dt_bias) between 0.001 and
    0.1) over one chunk of 256, x, B, C narrow (the overflow depends on A,
    dt and the chunk alone).  Heads whose log decay passes 88 over the
    chunk overflow exp(acs_t - acs_s) above the diagonal: jax.grad of the
    JAX package's ssd_chunked is NaN in their dt and A (its where(mask,
    exp(diff), 0) gives 0 * inf), so its first training step at this
    init has a NaN leaf.  The port's autograd through its plain version
    is finite, equals the backward's passes, and equals the reference
    wherever the reference is finite (1e-4 relative)."""
    from repro.models.ssm import SSMSpec, init_ssm_params

    H, P, N, c = 48, 8, 16, 256
    spec = SSMSpec(d_inner=H * 64, n_heads=H, headdim=64, d_state=128,
                   chunk=c)
    init = init_ssm_params(jax.random.PRNGKey(0), 1536, spec, jnp.float32)
    A = np.array(-jnp.exp(init["A_log"]))
    dt = np.broadcast_to(np.array(jax.nn.softplus(init["dt_bias"])),
                         (1, c, H)).copy()
    xh, _, _, Bc, Cc, D = _draw((1, c, H, P, N, c), seed=13)
    arrs = [xh, dt, A, Bc, Cc, D]
    dy, dh = _cotangents((1, c, H, P, N, c), seed=13)
    want = [np.asarray(w) for w in _jax_vjp(arrs, dy, dh, c)]
    nan = [np.isnan(w).any() for w in want]
    assert nan == [False, True, True, False, False, False]
    nan_heads, hot = np.isnan(want[2]), (-(dt * A).sum(1) > 88)[0]
    assert nan_heads.any() and not (nan_heads & ~hot).any()
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrs]
    y, h = ssd_scan(*leaves, chunk=c)
    got = torch.autograd.grad((y, h), leaves, (torch.from_numpy(dy),
                                               torch.from_numpy(dh)))
    assert all(torch.isfinite(g).all() for g in got)
    _assert_grads(got, ssd_passes_bwd(*map(torch.from_numpy, arrs),
                                      torch.from_numpy(dy),
                                      torch.from_numpy(dh), c))
    for name, g, w in zip(GRAD_NAMES, got, want):
        ok = np.isfinite(w)
        assert _rel(_np(g)[ok], w[ok]) < GRAD_TOL, name


def test_backward_wrapper_takes_card_tensors_only():
    """scan_bwd, the backward kernel's wrapper, raises on CPU tensors
    before it builds anything (the CPU path is autograd through the plain
    version); its buffer list names the C entry point's 21 pointers."""
    arrs = [torch.from_numpy(a) for a in _draw((1, 32, 2, 8, 16, 16))]
    with pytest.raises(ValueError, match="CUDA kernel given a tensor"):
        scan_bwd(*arrs, torch.zeros(1, 32, 2, 8), None,
                 torch.zeros(1, 2, 2, 8, 16), chunk=16)
    assert len(BWD_BUFFERS) == len(set(BWD_BUFFERS)) == 21
    assert set(bwd_scratch_shapes(1, 32, 2, 8, 16, 16)) < set(BWD_BUFFERS)


def test_backward_scratch_shapes():
    """The backward's fp32 scratch at mamba2-780m's training shape [1,
    4096]: dh_y / dS [B, nc, H, P, N], the chunk totals, the per-head parts
    of dB and dC [B, S, H, N] (201 MB of the 227 MB) and the per-chunk
    parts of dA and dD."""
    got = bwd_scratch_shapes(1, 4096, 48, 64, 128, 256)
    assert got["dstates"] == ((1, 16, 48, 64, 128), torch.float32)
    assert got["dB_heads"] == got["dC_heads"] == ((1, 4096, 48, 128),
                                                  torch.float32)
    assert got["chunk_sum"] == got["dA_part"] == got["dD_part"] == \
        ((1, 48, 16), torch.float32)
    nbytes = sum(np.prod(shape) * 4 for shape, _ in got.values())
    assert nbytes == 4 * (16 * 48 * 64 * 128 + 2 * 4096 * 48 * 128
                          + 3 * 48 * 16)


# ---------------------------------------------------------------------------
# the bf16 backward on wgmma: its path, scratch and plain passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,want", [
    ("main path", "wgmma"), ("chunk 64", "wgmma"), ("chunk 128", "wgmma"),
    ("fp32", "simple"), ("P 16", "simple"), ("N 16", "simple"),
    ("chunk 8", "simple"), ("chunk 512", "simple"),
    ("unaligned x", "simple"), ("unaligned dy", "simple"),
    ("dy expanded over the sequence", "simple"),
    ("dy strided view", "wgmma"), ("strided x view", "wgmma"),
    ("empty sequence", "simple"),
])
def test_backward_path_choice(case, want):
    """bwd_path: the wgmma backward takes what the forward's wgmma passes
    take (bf16 at P 64, N 128, a chunk that is a multiple of 64 up to 256,
    TMA-aligned x, B and C, a sequence that is not empty) with dy as TMA
    maps it too; all else goes to the simple kernels.  Pure Python, on CPU
    tensors."""
    xh, Bc, Cc = _main_widths()
    dy = torch.zeros((1, 256, 48, 64), dtype=torch.bfloat16)
    chunk = 256
    if case.startswith("chunk"):
        chunk = int(case.split()[1])
        if chunk == 512:
            xh, Bc, Cc = _main_widths(S=512)
            dy = torch.zeros((1, 512, 48, 64), dtype=torch.bfloat16)
    elif case == "fp32":
        xh, Bc, Cc = _main_widths(dtype=torch.float32)
        dy = dy.float()
    elif case == "P 16":
        xh, Bc, Cc = _main_widths(P=16)
        dy = dy[..., :16]
    elif case == "N 16":
        xh, Bc, Cc = _main_widths(N=16)
    elif case == "unaligned x":
        wide = torch.zeros((1, 256, 48 * 64 + 2), dtype=torch.bfloat16)
        xh = wide[..., 2:].view(1, 256, 48, 64)
        assert xh.data_ptr() % 16
    elif case == "unaligned dy":
        wide = torch.zeros((1, 256, 48 * 64 + 2), dtype=torch.bfloat16)
        dy = wide[..., 2:].view(1, 256, 48, 64)
        assert dy.data_ptr() % 16
    elif case == "dy expanded over the sequence":
        dy = torch.zeros((1, 1, 48, 64), dtype=torch.bfloat16).expand(
            1, 256, 48, 64)
    elif case == "dy strided view":   # heads transposed in memory
        dy = torch.zeros((1, 48, 256, 64), dtype=torch.bfloat16).transpose(
            1, 2)
        assert not dy.is_contiguous()
    elif case == "strided x view":
        flat = torch.zeros((1, 256, 48 * 64 + 256), dtype=torch.bfloat16)
        xh = flat[..., :48 * 64].view(1, 256, 48, 64)
        Bc, Cc = flat[..., 48 * 64:48 * 64 + 128], flat[..., 48 * 64 + 128:]
    elif case == "empty sequence":
        xh, Bc, Cc = _main_widths(S=0)
        dy = dy[:, :0]
    assert bwd_path(xh, Bc, Cc, dy, chunk) == want


def test_backward_wgmma_scratch_shapes():
    """The wgmma backward's scratch at mamba2-780m's training shape [1,
    4096]: fp32 dh_y / dS and the bf16 dS and h_before [B, nc, H, P, N],
    the chunk totals, the warps' parts of <h, dS>, the acs, dt, tail and
    inter rows [B, nc, H, c], C B^T (fp32) and the head-summed dCB (two
    bf16 terms) of the 10 tile pairs of each chunk, the parts of dA and dD:
    58.9 MB,
    with no [B, S, H, N] buffer (the simple path's per-head dB and dC
    parts, 201 MB of its 227 MB)."""
    got = bwd_scratch_shapes(1, 4096, 48, 64, 128, 256, path="wgmma")
    f, b = torch.float32, torch.bfloat16
    assert got == {
        "dstates": ((1, 16, 48, 64, 128), f), "chunk_sum": ((1, 48, 16), f),
        "ds_bf": ((1, 16, 48, 64, 128), b), "h_bf": ((1, 16, 48, 64, 128), b),
        "hds": ((1, 16, 48, 64), f), "acs": ((1, 16, 48, 256), f),
        "dts": ((1, 16, 48, 256), f), "tail": ((1, 16, 48, 256), f),
        "inter": ((1, 16, 48, 256), f), "cb": ((1, 16, 10, 64, 64), f),
        "dcb": ((1, 16, 10, 2, 64, 64), b), "dA_part": ((1, 48, 16), f),
        "dD_part": ((1, 48, 16), f)}
    assert (1, 4096, 48, 128) not in {shape for shape, _ in got.values()}
    nbytes = sum(np.prod(shape) * dtype.itemsize
                 for shape, dtype in got.values())
    state = 16 * 48 * 64 * 128
    assert nbytes == state * (4 + 2 + 2) + 16 * 48 * (64 + 4 * 256) * 4 + \
        16 * 10 * 4096 * (4 + 2 * 2) + 3 * 48 * 16 * 4
    assert nbytes == 58_926_080
    assert set(got) < set(BWD_WGMMA_BUFFERS)
    assert BWD_WGMMA_BUFFERS[:15] == BWD_BUFFERS[:15]
    assert len(BWD_WGMMA_BUFFERS) == len(set(BWD_WGMMA_BUFFERS)) == 28
    nt = bwd_scratch_shapes(2, 512, 3, 64, 128, 128, path="wgmma")
    assert nt["cb"] == ((2, 4, 3, 64, 64), f)   # 2 tiles: 3 pairs
    with pytest.raises(ValueError, match="unknown"):
        bwd_scratch_shapes(1, 256, 2, 64, 128, 256, path="tiled")


@pytest.mark.parametrize("dh_final", ["zero", "random"])
@pytest.mark.parametrize("shape", SHAPES)
def test_wgmma_backward_passes_match_jax_vjp(shape, dh_final):
    """The plain versions of the wgmma backward's passes, composed
    (ssd_passes_bwd(path="wgmma"): dh_y, the reverse state pass and
    chunk_bwd_summed, which sums dCB and the state terms over the heads
    before its products), against jax.vjp of the JAX package's
    ssd_chunked: every gradient to a relative 1e-4 in fp32."""
    arrs = _draw(shape, seed=14)
    dy, dh = _cotangents(shape, seed=14)
    dh = None if dh_final == "zero" else dh
    got = ssd_passes_bwd(*map(torch.from_numpy, arrs), torch.from_numpy(dy),
                         None if dh is None else torch.from_numpy(dh),
                         shape[-1], path="wgmma")
    _assert_grads(got, _jax_vjp(arrs, dy, dh, shape[-1]))


@pytest.mark.parametrize("shape", SHAPES)
def test_head_summed_pass_equals_the_per_head_passes(shape):
    """chunk_bwd_summed in fp32 (dB and dC from dCB summed over the heads,
    the state terms summed as formed) equals chunk_bwd followed by
    reduce_bwd (per-head parts, then their sums) to fp32 rounding (1e-5
    relative), and its dcb is the heads' sum of G L dt_s."""
    xh, dt, A, Bc, Cc, D = map(torch.from_numpy, _draw(shape, seed=15))
    dy, dh = map(torch.from_numpy, _cotangents(shape, seed=15))
    chunk = shape[-1]
    states, chunk_sum = chunk_state(xh, dt, A, Bc, chunk)
    h_before, _ = state_pass(states, chunk_sum)
    dh_y, chunk_sum = state_grad_from_y(dy, dt, A, Cc, chunk)
    dstates = state_pass_bwd(dh_y, chunk_sum, dh)
    args = (xh, dt, A, Bc, Cc, D, h_before, dstates, dy, chunk)
    got = chunk_bwd_summed(*args)
    want = reduce_bwd(chunk_bwd(*args))
    for name, w in zip(("dxh", "ddt", "dA", "dBc", "dCc", "dD"), want):
        g = got[name] if name not in ("dA", "dD") else \
            got[f"{name}_part"].sum((0, 2))
        assert g.shape == w.shape, name
        assert _rel(g.numpy(), w.numpy()) < 1e-5, name
    B_, S, H, P = xh.shape
    nc = S // chunk
    acs = (dt * A).reshape(B_, nc, chunk, H).cumsum(2)
    L = torch.exp(acs[:, :, :, None] - acs[:, :, None, :]) \
        * torch.tril(torch.ones(chunk, chunk))[None, None, :, :, None]
    G = torch.einsum("bnthp,bnshp->bntsh", dy.reshape(B_, nc, chunk, H, P),
                     xh.reshape(B_, nc, chunk, H, P))
    dcb = (G * L * dt.reshape(B_, nc, 1, chunk, H)).sum(-1)
    assert _rel(got["dcb"].numpy(), dcb.numpy()) < 1e-5


@pytest.mark.parametrize("shape", [(1, 256, 4, 16, 32, 64),
                                   (2, 512, 3, 64, 128, 256)])
def test_wgmma_backward_operand_rounding_within_tolerance(shape):
    """The wgmma backward's passes on bf16 inputs with its roundings (the
    forward's chunk-state operands; exp(acs) dy, h_before, dS, tail x, the
    scores and the head-summed dCB to bf16 as product operands; each
    gradient rounded to bf16 as the kernel writes it) against jax.vjp of
    the fp32 oracle on the same upcast inputs: within test_kernels.py's
    5e-2 on every gradient, and further from it than the same passes in
    fp32 (the rounding is what differs)."""
    arrs = [torch.from_numpy(a).bfloat16() for a in _draw(shape, seed=16)]
    dy, dh = _cotangents(shape, seed=16)
    dy16 = torch.from_numpy(dy).bfloat16()
    up = [a.float() for a in arrs]
    want = _jax_vjp([a.numpy() for a in up], dy16.float().numpy(), dh,
                    shape[-1])
    got = ssd_passes_bwd(*arrs, dy16, torch.from_numpy(dh), shape[-1],
                         operand_dtype=torch.bfloat16, path="wgmma")
    assert all(g.dtype == torch.bfloat16 for g in got)
    _assert_grads(got, want, tol=5e-2)
    got32 = ssd_passes_bwd(*up, dy16.float(), torch.from_numpy(dh),
                           shape[-1], path="wgmma")
    _assert_grads(got32, want)
    assert max(_rel(_np(g), _np(w)) for g, w in zip(got, want)) > \
        max(_rel(_np(g), _np(w)) for g, w in zip(got32, want))
    simple = ssd_passes_bwd(*arrs, dy16, torch.from_numpy(dh), shape[-1],
                            operand_dtype=torch.bfloat16)
    assert not all(torch.equal(g, s) for g, s in zip(got, simple))


def test_backward_passes_reject_an_unknown_path():
    arrs = [torch.from_numpy(a) for a in _draw((1, 32, 2, 8, 16, 16))]
    with pytest.raises(ValueError, match="unknown"):
        ssd_passes_bwd(*arrs, torch.zeros(1, 32, 2, 8), None, 16,
                       path="tiled")
