"""The port's flash attention on the CPU (its plain torch version, which is
what the front end runs for CPU tensors) against the JAX package's Pallas
kernel in interpret mode and its ``mha_ref`` oracle, on the same numpy
inputs: the sweep of ``tests/test_kernels.py`` (shapes, causal / window /
bidir / softcap, head_dim 64, 80 (hubert-xlarge's) and 128, fp32 at 1e-5
and bf16 at 2e-2, and bf16 also within
``BF16_ROW_TOL`` of each row's RMS), the GQA wrapper, and a sliding window
whose first KV tile is dead for some rows of a live q tile.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import gqa_flash_attention as jax_gqa
from repro.kernels.flash_attention.ref import mha_ref as jax_mha_ref
from repro_torch.kernels.flash_attention import (
    gqa_flash_attention, launches, reset_launches,
)
from repro_torch.kernels.flash_attention import ref as TR
from repro_torch.kernels.flash_attention.ref import (
    BF16_ROW_TOL, row_scaled_err,
)

pytestmark = pytest.mark.torch

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
MODES = {"causal": dict(causal=True, window=0, softcap=0.0),
         "bidir": dict(causal=False, window=0, softcap=0.0),
         "softcap": dict(causal=True, window=0, softcap=30.0)}


def _kw(mode, S):
    if mode == "window":
        return dict(causal=True, window=S // 4, softcap=0.0)
    return MODES[mode]


def _inputs(rng, shape, jdt, tdt):
    """The same values in both frameworks: numpy, rounded once to the
    dtype by JAX and carried over bit for bit."""
    arrs = [jnp.asarray(rng.normal(size=shape), jdt) for _ in range(3)]
    return arrs, [torch.from_numpy(np.array(a.astype(jnp.float32)))
                  .to(tdt) for a in arrs]


def _bhsd(q, k, v, **kw):
    """The port's attention on the JAX kernel's [B,H,S,D] layout."""
    return gqa_flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), **kw).transpose(1, 2)


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.astype(jnp.float32))


def _assert_close(got, want, tol):
    """Within ``tol`` absolute; a bf16 result also within BF16_ROW_TOL of
    each output row's RMS."""
    assert np.abs(_f32(got) - _f32(want)).max() < tol
    if got.dtype == torch.bfloat16:
        assert row_scaled_err(got, torch.tensor(_f32(want))) \
            < BF16_ROW_TOL


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(1, 2, 128, 64), (2, 4, 256, 64),
                                   (1, 2, 256, 128), (2, 4, 128, 80)])
@pytest.mark.parametrize("mode", ["causal", "window", "bidir", "softcap"])
def test_plain_version_matches_pallas_kernel_and_oracle(dtype, shape, mode):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng([shape[2], shape[3], len(mode)])
    (jq, jk, jv), (q, k, v) = _inputs(rng, shape, jdt, tdt)
    kw = _kw(mode, shape[2])
    got = _bhsd(q, k, v, block_q=64, block_k=64, **kw)
    assert got.dtype == tdt and tuple(got.shape) == shape
    pallas = jax_flash(jq, jk, jv, block_q=64, block_k=64, **kw)
    oracle = jax_mha_ref(jq.astype(jnp.float32), jk.astype(jnp.float32),
                         jv.astype(jnp.float32), **kw)
    _assert_close(got, pallas, tol)
    _assert_close(got, oracle, tol)


@pytest.mark.parametrize("mode", ["causal", "window", "bidir", "softcap"])
def test_mha_ref_twin(mode):
    rng = np.random.default_rng(3)
    (jq, jk, jv), (q, k, v) = _inputs(rng, (2, 2, 64, 32), jnp.float32,
                                      torch.float32)
    kw = _kw(mode, 64)
    np.testing.assert_allclose(TR.mha_ref(q, k, v, **kw).numpy(),
                               np.asarray(jax_mha_ref(jq, jk, jv, **kw)),
                               atol=1e-6)


def test_gqa_wrapper_matches_jax():
    rng = np.random.default_rng(11)
    Bn, S, H, KV, D = 2, 128, 8, 2, 64
    jq = jnp.asarray(rng.normal(size=(Bn, S, H, D)), jnp.float32)
    jk = jnp.asarray(rng.normal(size=(Bn, S, KV, D)), jnp.float32)
    jv = jnp.asarray(rng.normal(size=(Bn, S, KV, D)), jnp.float32)
    q, k, v = (torch.from_numpy(np.array(a)) for a in (jq, jk, jv))
    got = gqa_flash_attention(q, k, v, block_q=64, block_k=64)
    want = jax_gqa(jq, jk, jv, block_q=64, block_k=64)
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-5
    # and against the oracle on KV expanded by repeat, as the JAX test does
    kx = jnp.repeat(jk.transpose(0, 2, 1, 3), H // KV, axis=1)
    vx = jnp.repeat(jv.transpose(0, 2, 1, 3), H // KV, axis=1)
    ref = jax_mha_ref(jq.transpose(0, 2, 1, 3), kx, vx, causal=True)
    assert np.abs(got.numpy().transpose(0, 2, 1, 3)
                  - np.asarray(ref)).max() < 1e-5


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_window_with_a_dead_kv_tile_inside_a_live_q_tile(dtype):
    """Window 40 with 64-row tiles: KV tile 0 is live for q tile 1 (row 64
    sees keys 25..64) but dead for its rows 104..127, which see garbage
    p = exp(0) there until tile 1 wipes it with corr = 0."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(40)
    shape = (1, 2, 256, 64)
    (jq, jk, jv), (q, k, v) = _inputs(rng, shape, jdt, tdt)
    kw = dict(causal=True, window=40, softcap=50.0)
    got = _bhsd(q, k, v, **kw)
    pallas = jax_flash(jq, jk, jv, block_q=64, block_k=64, **kw)
    oracle = jax_mha_ref(jq.astype(jnp.float32), jk.astype(jnp.float32),
                         jv.astype(jnp.float32), **kw)
    assert np.isfinite(_f32(got)).all()
    _assert_close(got, pallas, tol)
    _assert_close(got, oracle, tol)


def test_plain_version_equals_the_model_paths():
    """Three-way agreement, as in the JAX package: flash == the model's
    chunked == naive attention, all of the port."""
    from repro_torch.models.attention import (
        AttnSpec, _attend_chunked, _attend_naive, _group_q,
    )
    rng = np.random.default_rng(5)
    Bn, S, H, KV, D = 2, 128, 4, 2, 64
    spec = AttnSpec(n_heads=H, n_kv_heads=KV, head_dim=D)
    q = torch.from_numpy(rng.normal(size=(Bn, S, H, D)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(Bn, S, KV, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(Bn, S, KV, D)).astype(np.float32))
    pos = torch.arange(S, dtype=torch.int32)
    naive = _attend_naive(_group_q(q, KV), k, v, pos, pos, spec)
    chunked = _attend_chunked(_group_q(q, KV), k, v, pos, pos, spec, 32)
    flash = gqa_flash_attention(q, k, v).reshape(naive.shape)
    assert (naive - chunked).abs().max() < 1e-5
    assert (naive - flash).abs().max() < 1e-5


def test_cpu_tensors_never_launch_the_kernel():
    reset_launches()
    q = torch.zeros((1, 64, 4, 64))
    gqa_flash_attention(q, q[:, :, :2], q[:, :, :2])
    assert launches == {"flash_attention": 0}


@pytest.mark.parametrize("S, heads", [(200, (4, 2)), (128, (4, 4)),
                                      (128, (4, 2)), (128, (8, 2))])
def test_edge_shapes_match_pallas_kernel(S, heads):
    """The card tests' edge shapes at CPU size (``FLASH_EDGE_CASES`` of
    tests/test_torch_cuda.py): a length that is no multiple of 64, and
    H // KV in {1, 2, 4}, in bf16 against the JAX GQA wrapper (Pallas in
    interpret mode) with a window and a softcap."""
    H, KV = heads
    rng = np.random.default_rng([S, H, KV])
    arrs = [jnp.asarray(rng.normal(size=(1, S, h, 64)), jnp.bfloat16)
            for h in (H, KV, KV)]
    q, k, v = (torch.from_numpy(np.array(a.astype(jnp.float32)))
               .to(torch.bfloat16) for a in arrs)
    kw = dict(causal=True, window=S // 3, softcap=50.0)
    got = gqa_flash_attention(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (1, S, H, 64)
    _assert_close(got, jax_gqa(*arrs, **kw), 2e-2)


def test_layout_check_takes_what_tma_maps():
    """The wrapper's layout rules (TMA's): a 16-byte aligned start, strides
    in multiples of 16 bytes, no broadcast (stride 0) axis longer than 1."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        _check_layout,
    )
    cpu, bf16 = torch.device("cpu"), torch.bfloat16
    x = torch.zeros((1, 64, 4, 64), dtype=bf16)
    for ok in (x, x.transpose(1, 2).contiguous().transpose(1, 2),
               x[:, :, :1], x[:, 8:40, 1:3]):
        _check_layout("q", ok, bf16, cpu)
    with pytest.raises(ValueError, match="stride 0"):
        _check_layout("k", x[:, :, :1].expand(1, 64, 2, 64), bf16, cpu)
    with pytest.raises(ValueError, match="16-byte"):
        _check_layout("v", torch.zeros(x.numel() + 4, dtype=bf16)[4:]
                      .view_as(x), bf16, cpu)
    with pytest.raises(ValueError, match="16-byte"):
        _check_layout("v", torch.zeros((1, 64, 4, 68), dtype=bf16)[..., :64],
                      bf16, cpu)
    with pytest.raises(TypeError):
        _check_layout("v", x.float(), bf16, cpu)


@pytest.mark.parametrize("edit", ["shared_header", "package_source",
                                  "package_header"])
def test_build_hash_covers_sources_and_headers(tmp_path, edit):
    """kernels/build.py keys a library by its sources and the headers they
    may include (the package's own and kernels/csrc/, passed as -I), so an
    edit to any of them names another library and nothing stale loads."""
    import shutil

    from repro_torch.kernels import build as B
    from repro_torch.kernels.flash_attention.flash_attention import CSRC

    csrc, inc = tmp_path / "csrc", tmp_path / "include"
    shutil.copytree(CSRC, csrc)
    shutil.copytree(B.INCLUDE, inc)
    assert (inc / "hopper.cuh").exists()
    before = B.library_path("flash_attention", csrc, inc)
    assert before == B.library_path("flash_attention", csrc, inc)
    target = {"shared_header": inc / "hopper.cuh",
              "package_source": csrc / "flash_attention_bwd.cu",
              "package_header": csrc / "local.cuh"}[edit]
    text = target.read_text() if target.exists() else ""
    target.write_text(text + "\n// edited\n")
    after = B.library_path("flash_attention", csrc, inc)
    assert after != before and after.parent.parent == before.parent.parent


#: Position vectors the card tests also use (S = 64): repeated ids (an
#: image's patches), a sequence that steps back, gaps.
POSITIONS = {
    "repeated": np.concatenate([np.arange(8), np.full(40, 8),
                                np.arange(9, 25)]),
    "non_monotone": np.random.default_rng(3).permutation(64) // 2,
    "gaps": np.arange(64) * 7 - 100,
}


@pytest.mark.parametrize("which", list(POSITIONS))
@pytest.mark.parametrize("mode", ["causal", "window", "bidir", "softcap"])
def test_plain_version_masks_by_position_as_jax_default_path(which, mode):
    """positions given: the plain version against the JAX package's naive
    attention (its default path) with q_pos = k_pos = positions."""
    import importlib
    JA = importlib.import_module("repro.models.attention")

    S, H, KV, D = 64, 4, 2, 16
    kw = _kw(mode, 24)
    rng = np.random.default_rng(len(which) + len(mode))
    q, k, v = (rng.normal(size=(2, S, h, D)).astype(np.float32)
               for h in (H, KV, KV))
    pos = POSITIONS[which].astype(np.int32)
    spec = JA.AttnSpec(n_heads=H, n_kv_heads=KV, head_dim=D,
                       causal=kw["causal"], sliding_window=kw["window"],
                       attn_softcap=kw["softcap"])
    want = JA._attend_naive(JA._group_q(jnp.asarray(q), KV), jnp.asarray(k),
                            jnp.asarray(v), jnp.asarray(pos),
                            jnp.asarray(pos), spec).reshape(2, S, H, D)
    got = gqa_flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v),
                              positions=torch.from_numpy(pos), **kw)
    _assert_close(got, want, 1e-5)


def test_plain_version_index_positions_equal_no_positions():
    """positions 0..S-1 give exactly the index masks."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 96, h, 32)).astype(
        np.float32)) for h in (4, 2, 2))
    for kw in (dict(causal=True), dict(causal=True, window=20, softcap=30.0),
               dict(causal=False)):
        assert torch.equal(
            gqa_flash_attention(q, k, v, **kw),
            gqa_flash_attention(q, k, v, positions=torch.arange(
                96, dtype=torch.int32), **kw))


#: The card tests' five masking modes (tests/test_torch_cuda.py
#: FLASH_MODES) at CPU size.
SMALL_D_MODES = {
    "causal": dict(causal=True, window=0, softcap=0.0),
    "window": dict(causal=True, window=24, softcap=0.0),
    "bidir": dict(causal=False, window=0, softcap=0.0),
    "softcap": dict(causal=True, window=0, softcap=50.0),
    "window_softcap": dict(causal=True, window=16, softcap=50.0),
}


@pytest.mark.parametrize("D", [8, 16, 32])
@pytest.mark.parametrize("mode", list(SMALL_D_MODES))
def test_plain_version_at_small_head_dims_matches_jax_naive(D, mode):
    """head_dim 8, 16 (every smoke config's) and 32 (examples/train_e2e.py's):
    the plain version's output against the JAX package's default path
    (``_attend_naive``) within 1e-5, and its gradient
    (``flash_attention_bwd_ref``) against ``jax.vjp`` of that path within
    1e-5 of each tensor's largest magnitude (tests/test_torch_train.py's
    bound), fp32, on the same numpy inputs."""
    import importlib

    import jax

    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref,
    )
    JA = importlib.import_module("repro.models.attention")

    B, S, H, KV = 2, 80, 4, 2
    kw = SMALL_D_MODES[mode]
    rng = np.random.default_rng([D, len(mode)])
    q, dout = (rng.normal(size=(B, S, H, D)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.normal(size=(B, S, KV, D)).astype(np.float32)
            for _ in range(2))
    pos = jnp.arange(S, dtype=jnp.int32)
    spec = JA.AttnSpec(n_heads=H, n_kv_heads=KV, head_dim=D,
                       causal=kw["causal"], sliding_window=kw["window"],
                       attn_softcap=kw["softcap"])

    def attend(q, k, v):
        return JA._attend_naive(JA._group_q(q, KV), k, v, pos, pos,
                                spec).reshape(B, S, H, D)

    want, vjp = jax.vjp(attend, *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = gqa_flash_attention(tq, tk, tv, **kw)
    _assert_close(got, want, 1e-5)
    grads = flash_attention_bwd_ref(tq, tk, tv, got, torch.from_numpy(dout),
                                    **kw)
    for g, w, t in zip(grads, vjp(jnp.asarray(dout)), (tq, tk, tv)):
        assert g.shape == t.shape
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("G", [5, 7])
def test_kv_splits_of_a_prime_group_is_one_block_or_one_per_head(G):
    """qwen3-14b's GQA groups of 5 and qwen2-vl-7b's of 7: the backward's
    dk/dv blocks per key tile are the least divisor of G that gives the
    card's SMs (132 on an H100) two blocks each, so 1 where the key tiles
    alone do and G elsewhere (each query head of the group its own
    block)."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        WGMMA_TILE, kv_splits,
    )
    for KV in (4, 8):
        for Sk in (64, 200, 1024, 4096, 4224, 8192):
            tiles = KV * -(-Sk // WGMMA_TILE)
            want = 1 if tiles >= 2 * 132 else G
            assert kv_splits(1, KV, Sk, G, 132, WGMMA_TILE) == want
