"""The hand-written CUDA kernels (dvv_ops, flash_attention and its
backward, ssd_scan and its backward) against their plain torch versions,
on the card.
Imports neither jax nor the JAX package, so it runs on a machine that has
only the port:

    PYTHONPATH=src python -m pytest -q -m torch tests/test_torch_cuda.py

Every test needs a CUDA device (the kernels have no CPU mode) and skips
without one.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.core import DVV_MECHANISM
from repro_torch.core import batched as TB
from repro_torch.kernels.dvv_ops import ops, ref
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.flash_attention.ref import (
    BF16_ROW_TOL, flash_attention_ref, row_scaled_err,
)
from repro_torch.store import KVClient, KVCluster

pytestmark = pytest.mark.torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the dvv_ops kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _grouped(N, K, R, seed=0):
    rng = np.random.default_rng(seed)
    vvs = rng.integers(0, 6, (N, K, R)).astype(np.int32)
    dids = rng.integers(-1, R, (N, K)).astype(np.int32) if R else \
        np.full((N, K), -1, np.int32)
    dns = np.zeros((N, K), np.int32)
    if R:
        dns = np.where(dids >= 0, np.take_along_axis(
            vvs, np.clip(dids, 0, None)[..., None], axis=-1)[..., 0]
            + rng.integers(1, 4, (N, K)), 0).astype(np.int32)
    valid = rng.random((N, K)) < 0.8
    return vvs, dids, dns, valid


def _t(arrays, device):
    return [torch.from_numpy(np.asarray(a)).to(device) for a in arrays]


@pytest.mark.parametrize("shape", [(1, 1, 1), (19, 4, 3), (4096, 4, 8),
                                   (1000, 9, 0), (300, 40, 5), (7, 300, 2)])
def test_kernels_equal_plain_versions(cuda, shape):
    on_card = _t(_grouped(*shape, seed=sum(shape)), cuda)
    ops.reset_launches()
    mask = ops.dvv_sync_mask(*on_card)
    smask, ceil = ops.dvv_read_sweep(*on_card)
    torch.cuda.synchronize()
    want_mask, want_ceil = ref.read_sweep_ref(*on_card)
    assert torch.equal(mask, want_mask) and torch.equal(smask, want_mask)
    assert torch.equal(ceil, want_ceil)
    vvs, dids, dns, _ = on_card
    pairs = (vvs[:, 0].contiguous(), dids[:, 0].contiguous(),
             dns[:, 0].contiguous(), vvs[:, -1].contiguous(),
             dids[:, -1].contiguous(), dns[:, -1].contiguous())
    assert torch.equal(ops.dvv_leq(*pairs), ref.leq_ref(*pairs))
    assert ops.launches == {"dvv_sync_mask": 1, "dvv_read_sweep": 1,
                            "dvv_leq": 1}


def test_padded_buckets_equal_numpy_twin(cuda):
    args = _grouped(13, 3, 5, seed=4)
    want = TB.sync_mask_np(*args)
    np.testing.assert_array_equal(ops.dvv_sync_mask_bucketed(cuda)(*args),
                                  want)
    mask, ceil = ops.dvv_read_sweep_bucketed(cuda)(*args)
    np.testing.assert_array_equal(mask, want)
    for n in range(13):
        s = np.flatnonzero(want[n])
        np.testing.assert_array_equal(ceil[n], TB.grouped_ceiling_np(
            args[0][n][s], args[1][n][s], args[2][n][s],
            np.zeros(len(s), np.int64), 1)[0])


def test_wrapper_rejects_bad_inputs(cuda):
    vvs, dids, dns, valid = _t(_grouped(8, 2, 3), cuda)
    with pytest.raises(TypeError):
        ops.dvv_sync_mask(vvs.long(), dids, dns, valid)
    with pytest.raises(ValueError):
        ops.dvv_sync_mask(vvs.transpose(0, 1), dids, dns, valid)
    with pytest.raises(ValueError):
        ops.dvv_sync_mask(vvs, dids.cpu(), dns, valid)


def test_cluster_on_the_card_launches_the_kernels(cuda):
    ops.reset_launches()
    c = KVCluster(("a", "b", "c"), DVV_MECHANISM, replication=2,
                  read_quorum=2, shards=2)
    cl = KVClient(c, "t", via="a")
    keys = [f"k{i}" for i in range(64)]
    cl.put_many({k: (k, None) for k in keys})
    c.deliver_replication()
    c.delta_antientropy_round()
    got = cl.get_many(keys)
    assert all(got[k].values == (k,) for k in keys)
    assert ops.launches["dvv_sync_mask"] > 0
    assert ops.launches["dvv_read_sweep"] > 0


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

FLASH_MODES = {
    "causal": dict(causal=True, window=0, softcap=0.0),
    "window": dict(causal=True, window=100, softcap=0.0),
    "bidir": dict(causal=False, window=0, softcap=0.0),
    "softcap": dict(causal=True, window=0, softcap=50.0),
    "window_softcap": dict(causal=True, window=100, softcap=50.0),
}
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _assert_flash_close(got, want):
    """Within FLASH_TOL absolute; bf16 also within BF16_ROW_TOL of each
    output row's RMS, which shrinks as a row averages more keys."""
    assert float((got.float() - want.float()).abs().max()) \
        < FLASH_TOL[got.dtype]
    if got.dtype == torch.bfloat16:
        assert row_scaled_err(got, want) < BF16_ROW_TOL


def _qkv(B, S, H, KV, D, dtype, device, seed=0):
    rng = np.random.default_rng([seed, S, H, KV, D])
    return [torch.from_numpy(rng.normal(size=(B, S, h, D)).astype(
        np.float32)).to(device=device, dtype=dtype) for h in (H, KV, KV)]


@pytest.fixture
def ieee_fp32():
    """The plain version's fp32 matmuls must not run in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 80, 128, 256])
@pytest.mark.parametrize("heads", [(16, 8), (4, 1)])
@pytest.mark.parametrize("mode", list(FLASH_MODES))
def test_flash_kernel_equals_plain_version(cuda, ieee_fp32, dtype, D, heads,
                                           mode):
    """S = 320: five 64-row q tiles; window 100 leaves KV tiles that are
    dead for some rows of a live q tile."""
    q, k, v = _qkv(2, 320, *heads, D, dtype, cuda)
    FA.reset_launches()
    got = FA.gqa_flash_attention(q, k, v, **FLASH_MODES[mode])
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, **FLASH_MODES[mode])
    assert FA.launches == {"flash_attention": 1}
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    _assert_flash_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 100, 129])
def test_flash_kernel_ragged_lengths(cuda, ieee_fp32, dtype, S):
    q, k, v = _qkv(1, S, 4, 2, 128, dtype, cuda, seed=1)
    for mode in ("causal", "bidir", "window_softcap"):
        got = FA.gqa_flash_attention(q, k, v, **FLASH_MODES[mode])
        want = flash_attention_ref(q, k, v, **FLASH_MODES[mode])
        _assert_flash_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_jax_layout_and_scale(cuda, ieee_fp32, dtype):
    """[B,H,S,D] tensors with KV pre-expanded, as the JAX kernel takes
    them, seen as [B,S,H,D] views: the kernel takes the heads axis by
    strides; an explicit scale, and 0.0 as the default."""
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in _qkv(2, 192, 4, 4, 64, dtype, cuda, seed=2))
    assert not q.is_contiguous()
    for scale in (0.0, 0.3):
        got = FA.gqa_flash_attention(q, k, v, causal=True, scale=scale)
        want = flash_attention_ref(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=True, scale=scale)
        assert got.shape == q.shape
        _assert_flash_close(got, want)


#: Shapes that exercise the bf16 kernel's TMA ring and edge tiles (128 q
#: rows a block, 80-key tiles, a ring of 2, 4 or 8 stages at D = 256, 128,
#: 64): (S, (H, KV), window, softcap).
FLASH_EDGE_CASES = {
    # S not a multiple of the tiles: TMA zero-fills keys (S = 200) and q
    # rows (both) past the end, and the last q tile is ragged
    "S200": (200, (4, 2), 0, 50.0),
    "S4160": (4160, (2, 1), 0, 0.0),
    # the window's lower edge crosses 128-row q tiles; the ring wraps many
    # times in every block
    "S4608_window4096": (4608, (2, 1), 4096, 50.0),
    # rows 119..127 see none of keys 0..79, a live edge tile of their
    # warpgroup (rows 64..127): fully masked rows inside a live tile
    "window40": (256, (2, 2), 40, 0.0),
    # H // KV in {1, 2, 4}
    "gqa1": (320, (4, 4), 0, 50.0),
    "gqa2": (320, (4, 2), 100, 0.0),
    "gqa4": (320, (8, 2), 0, 0.0),
}


@pytest.mark.parametrize("D", [64, 80, 128, 256])
@pytest.mark.parametrize("case", list(FLASH_EDGE_CASES))
def test_flash_kernel_edge_shapes(cuda, D, case):
    S, (H, KV), window, cap = FLASH_EDGE_CASES[case]
    q, k, v = _qkv(1, S, H, KV, D, torch.bfloat16, cuda, seed=3)
    kw = dict(causal=True, window=window, softcap=cap)
    got = FA.gqa_flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, **kw)
    assert torch.isfinite(got).all()
    _assert_flash_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["fused_projection", "padded"])
def test_flash_kernel_strided_views(cuda, ieee_fp32, dtype, layout):
    """Views whose tensor maps take non-contiguous strides: q, k and v cut
    from one fused [B, S, H + 2 KV, D] projection (position stride
    (H + 2 KV) D, head stride D), or padded along every axis."""
    B, S, H, KV, D = 2, 192, 4, 2, 128
    if layout == "fused_projection":
        x = _qkv(B, S, H + 2 * KV, 1, D, dtype, cuda, seed=5)[0]
        q, k, v = x[:, :, :H], x[:, :, H:H + KV], x[:, :, H + KV:]
    else:
        q, k, v = (t[:, 3:S + 3, 1:h + 1, :D] for t, h in zip(
            _qkv(B, S + 8, H + 2, KV + 2, D + 64, dtype, cuda, seed=6),
            (H, KV, KV)))
    assert not q.is_contiguous() and not k.is_contiguous()
    for mode in ("causal", "window_softcap"):
        got = FA.gqa_flash_attention(q, k, v, **FLASH_MODES[mode])
        want = flash_attention_ref(q.contiguous(), k.contiguous(),
                                   v.contiguous(), **FLASH_MODES[mode])
        _assert_flash_close(got, want)


def test_flash_wrapper_rejects_bad_inputs(cuda):
    q, k, v = _qkv(1, 64, 4, 2, 64, torch.bfloat16, cuda)
    with pytest.raises(TypeError):
        FA.gqa_flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        FA.gqa_flash_attention(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(ValueError):
        FA.gqa_flash_attention(q, k[:, :, :1].expand(1, 64, 3, 64), v)
    with pytest.raises(ValueError):
        FA.gqa_flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="stride 0"):
        FA.gqa_flash_attention(q, k[:, :, :1].expand(1, 64, 2, 64), v)
    shifted = torch.zeros(v.numel() + 4, dtype=v.dtype, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):                # 8 bytes
        FA.gqa_flash_attention(q, k, shifted[4:].view_as(v))


@pytest.mark.parametrize("arch", ["gemma2-9b", "qwen3-moe-30b-a3b",
                                  "hubert-xlarge"])
def test_prefill_on_the_card_runs_the_kernel_once_per_layer(cuda, ieee_fp32,
                                                            arch):
    """The smoke config with head_dim 64 (the kernel's smallest), or
    hubert-xlarge's own 80 (bidirectional, frame embeddings in): fp32
    logits on the card equal the CPU run of the same parameters (the MoE's
    routing, capacity and einsums on the card included)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_params

    cfg = replace(get_config(arch).smoke(),
                  head_dim=80 if arch == "hubert-xlarge" else 64,
                  compute_dtype="float32")
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(0)
    if cfg.input_mode == "tokens":
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, 96)).astype(np.int32))}
    else:
        batch = {"embeddings": torch.from_numpy(rng.normal(
            size=(2, 96, cfg.d_model)).astype(np.float32))}
    prefill = make_prefill_step(cfg)
    want = prefill(params, batch)
    FA.reset_launches()
    got = prefill(_to(params, cuda), _to(batch, cuda))
    torch.cuda.synchronize()
    assert FA.launches["flash_attention"] == cfg.n_layers
    assert float((got.cpu() - want).abs().max()) < 1e-4


@pytest.mark.parametrize("case", ["drops", "no_drops"])
def test_moe_ffn_on_the_card_equals_the_cpu_run(cuda, ieee_fp32, case):
    """moe_ffn (fp32, E 16, K 8, groups of 256 tokens) on the card against
    the same call on the CPU copy: the same experts (lower index first on
    ties), the same capacity drops (fraction_dropped bitwise), out and the
    losses to fp32 summation order.  "drops" adds a shared direction to
    every token so that a few experts overflow."""
    from repro_torch.models.moe import MoESpec, init_moe_params, moe_ffn, route

    spec = MoESpec(n_experts=16, top_k=8, d_ff=96)
    params = init_moe_params(torch.Generator().manual_seed(0), 64, spec,
                             torch.float32)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 256, 64))
    if case == "drops":
        x = 0.3 * (x + 3.0 * rng.normal(size=(64,)))
    x = torch.from_numpy(x.astype(np.float32))
    want, wm = moe_ffn(params, x, spec)
    on_card = _to(params, cuda)
    got, gm = moe_ffn(on_card, x.to(cuda), spec)
    assert torch.equal(route(on_card, x.to(cuda), spec)[3].cpu(),
                       route(params, x, spec)[3])
    assert float((got.cpu() - want).abs().max()) < 1e-5
    assert gm["fraction_dropped"].cpu() == wm["fraction_dropped"]
    assert (float(wm["fraction_dropped"]) > 0) == (case == "drops")
    for key in ("aux_loss", "z_loss"):
        assert abs(float(gm[key]) - float(wm[key])) < 1e-6


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---------------------------------------------------------------------------
# ssd_scan
# ---------------------------------------------------------------------------

def _ssd_inputs(B, S, H, P, N, dtype, device, seed=0):
    """test_kernels.py's distribution; xh is the [B,S,H,P] view of a
    [B,S,H*P] tensor, as ssm_forward passes it."""
    rng = np.random.default_rng([seed, B, S, H, P, N])

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device, dtype)

    xh = t(rng.normal(size=(B, S, H * P))).view(B, S, H, P)
    return [xh, t(rng.uniform(0.01, 0.2, size=(B, S, H))),
            t(-rng.uniform(0.5, 2.0, size=(H,))),
            t(rng.normal(size=(B, S, N))), t(rng.normal(size=(B, S, N))),
            t(rng.normal(size=(H,)))]


def _rel(got, want):
    return float((got.double() - want.double()).abs().max()
                 / (want.double().abs().max() + 1e-9))


SSD_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}   # test_kernels.py


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [8, 64, 256])
@pytest.mark.parametrize("P", [16, 64])
@pytest.mark.parametrize("N", [16, 128])
def test_ssd_kernel_equals_plain_version(cuda, ieee_fp32, dtype, chunk, P,
                                         N):
    """y and h_final within SSD_TOL (relative to the largest value) of the
    plain version run in fp32 on the upcast inputs; B x H from 1 x 2 to
    2 x 48, several chunks a sequence."""
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    B, H = {8: (1, 2), 64: (2, 5), 256: (2, 48)}[chunk]
    S = 8 * chunk if chunk < 64 else 3 * chunk
    args = _ssd_inputs(B, S, H, P, N, dtype, cuda)
    SS.reset_launches()
    y, h = SS.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert SS.launches == {"ssd_scan": 1}
    assert y.dtype == dtype and y.shape == (B, S, H, P)
    assert h.dtype == torch.float32 and h.shape == (B, H, P, N)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    want_y, want_h = ssd_chunked(*(a.float() for a in args), chunk)
    assert _rel(y, want_y) < SSD_TOL[dtype]
    assert _rel(h, want_h) < SSD_TOL[dtype]


def test_ssd_kernel_mixed_scalar_dtypes(cuda, ieee_fp32):
    """bf16 streams with fp32 A and D, as the wrapper accepts them."""
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    args = _ssd_inputs(1, 128, 4, 64, 128, torch.bfloat16, cuda, seed=1)
    args[2], args[5] = args[2].float(), args[5].float()
    y, h = SS.ssd_scan(*args, chunk=64)
    want_y, want_h = ssd_chunked(*(a.float() for a in args), 64)
    assert _rel(y, want_y) < 5e-2 and _rel(h, want_h) < 5e-2


def test_ssd_wrapper_rejects_bad_inputs(cuda):
    from repro_torch.kernels import ssd_scan as SS

    args = _ssd_inputs(1, 64, 2, 16, 16, torch.bfloat16, cuda)
    with pytest.raises(TypeError):
        SS.ssd_scan(*(a.half() for a in args), chunk=16)
    with pytest.raises(TypeError):
        SS.ssd_scan(args[0], args[1].float(), *args[2:], chunk=16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        SS.ssd_scan(*args, chunk=48)
    with pytest.raises(ValueError):
        SS.ssd_scan(args[0], args[1], args[2], args[3].cpu(), *args[4:],
                    chunk=16)
    with pytest.raises(ValueError):
        SS.ssd_scan(*_ssd_inputs(1, 64, 2, 128, 16, torch.bfloat16, cuda),
                    chunk=16)
    with pytest.raises(ValueError, match="multiple of 4"):
        SS.ssd_scan(*args, chunk=2)


def test_mamba_prefill_on_the_card_runs_the_kernel_once_per_layer(
        cuda, ieee_fp32):
    """mamba2-780m cut to 4 layers at full width, fp32 compute, 512 tokens
    (two chunks): logits on the card within 1e-4 of the largest logit of
    the CPU run of the same parameters (cuBLAS and the kernel sum in other
    orders than the CPU)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_params

    cfg = replace(get_config("mamba2-780m"), n_layers=4,
                  compute_dtype="float32")
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 512)).astype(np.int32))
    prefill = make_prefill_step(cfg)
    want = prefill(params, {"tokens": toks})
    SS.reset_launches()
    got = prefill(_to(params, cuda), {"tokens": toks.to(cuda)})
    torch.cuda.synchronize()
    assert SS.launches["ssd_scan"] == cfg.n_layers
    assert _rel(got.cpu(), want) < 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_unaligned_streams(cuda, ieee_fp32, dtype):
    """Widths whose rows are not whole 16-byte vectors (P 12, N 20) and an
    xh that starts 4 bytes into its buffer: the kernel's element-by-element
    loads, and for bf16 its FMA scores (N % 16 != 0)."""
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    B, S, H, P, N = 2, 64, 3, 12, 20
    args = _ssd_inputs(B, S, H, P, N, dtype, cuda, seed=4)
    wide = torch.zeros((B, S, H * P + 2), dtype=dtype, device=cuda)
    wide[..., 2:] = args[0].reshape(B, S, H * P)
    args[0] = wide[..., 2:].view(B, S, H, P)
    assert args[0].data_ptr() % 16
    y, h = SS.ssd_scan(*args, chunk=16)
    want_y, want_h = ssd_chunked(*(a.float() for a in args), 16)
    assert _rel(y, want_y) < SSD_TOL[dtype]
    assert _rel(h, want_h) < SSD_TOL[dtype]


@pytest.mark.parametrize("chunk,H", [(64, 5), (256, 48)])
def test_ssd_passes_equal_plain_versions(cuda, ieee_fp32, chunk, H):
    """Each pass of the bf16 wgmma path against its plain version (ref.py,
    with the kernel's bf16 operand rounding) on the same inputs: the chunk
    states and totals of pass 1 from the scan's inputs; h_before and
    h_final of pass 2 from the kernel's states and totals; y of pass 3 from
    the kernel's h_before.  1e-2 of the largest value (ex2.approx and the
    order of fp32 sums against torch's exp and cumsum, which can flip a
    bf16 rounding of an operand)."""
    from repro_torch.kernels.ssd_scan import ref
    from repro_torch.kernels.ssd_scan.ssd_scan import passes

    args = _ssd_inputs(2, 4 * chunk, H, 64, 128, torch.bfloat16, cuda,
                       seed=2)
    got = passes(*args, chunk=chunk)
    torch.cuda.synchronize()
    bf = torch.bfloat16
    states, chunk_sum = ref.chunk_state(*args[:4], chunk, bf)
    assert _rel(got["states"], states) < 1e-2
    assert _rel(got["chunk_sum"], chunk_sum) < 1e-5
    h_before, h_final = ref.state_pass(got["states"], got["chunk_sum"], bf)
    assert got["h_before"].dtype == bf
    assert _rel(got["h_before"], h_before) < 1e-2
    assert _rel(got["h_final"], h_final) < 1e-5
    y = ref.chunk_out(*args, got["h_before"], chunk, bf)
    assert _rel(got["y"], y) < 1e-2


def test_ssd_main_widths_take_the_wgmma_path(cuda, ieee_fp32):
    """mamba2-780m's widths (48 heads of 64, state 128, chunk 256) at
    [1, 4096] bf16 go through the wgmma passes, one launch counted."""
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.kernels.ssd_scan.ssd_scan import path_launches, wgmma_path

    args = _ssd_inputs(1, 4096, 48, 64, 128, torch.bfloat16, cuda)
    assert wgmma_path(args[0], args[3], args[4], 256) == "wgmma"
    SS.reset_launches()
    SS.ssd_scan(*args, chunk=256)
    torch.cuda.synchronize()
    assert SS.launches == {"ssd_scan": 1}
    assert path_launches == {"wgmma": 1, "simple": 0}


def test_ssd_main_widths_bf16(cuda, ieee_fp32):
    """[1, 4096] bf16 at mamba2-780m's widths against the plain version run
    in fp32 on the upcast inputs, to test_kernels.py's 5e-2."""
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    args = _ssd_inputs(1, 4096, 48, 64, 128, torch.bfloat16, cuda, seed=3)
    y, h = SS.ssd_scan(*args, chunk=256)
    want_y, want_h = ssd_chunked(*(a.float() for a in args), 256)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    assert _rel(y, want_y) < 5e-2 and _rel(h, want_h) < 5e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_is_deterministic(cuda, dtype):
    """Two calls on the same inputs give bitwise-equal y and h_final (no
    atomics, no order that changes from run to run)."""
    from repro_torch.kernels import ssd_scan as SS

    args = _ssd_inputs(2, 1024, 48, 64, 128, dtype, cuda, seed=5)
    y0, h0 = SS.ssd_scan(*args, chunk=256)
    y1, h1 = SS.ssd_scan(*args, chunk=256)
    assert torch.equal(y0, y1) and torch.equal(h0, h1)


def test_ssd_scan_bitwise_equal_to_parent_build(cuda):
    """Both paths (the wgmma passes at mamba2-780m's widths, the simple
    kernel in fp32) against a build of the parent commit's ssd_scan.cu and
    ssd_passes.cu (build/ssd_scan_parent/, or $SSD_PARENT_DIR): the
    shared Hopper header changed no output bit."""
    import importlib

    from repro_torch.kernels import ssd_scan as SS
    SSK = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")

    parent = SSK.load(_parent_build("ssd_scan_parent", "SSD_PARENT_DIR",
                                    "ssd_scan_parent",
                                    ["ssd_scan.cu", "ssd_passes.cu"]))
    for dtype, path in ((torch.bfloat16, "wgmma"), (torch.float32, "simple")):
        args = _ssd_inputs(2, 2048, 48, 64, 128, dtype, cuda, seed=6)
        y0, h0 = SS.ssd_scan(*args, chunk=256)
        y1, h1 = SSK.scan(*args, chunk=256, lib=parent, path=path)
        assert torch.equal(y0, y1) and torch.equal(h0, h1), dtype


# ---------------------------------------------------------------------------
# ssd_scan's backward
# ---------------------------------------------------------------------------

SSD_GRAD_NAMES = ("dxh", "ddt", "dA", "dBc", "dCc", "dD")
#: fp32 gradients: max abs error over the plain version's largest
#: magnitude (fp32 sums in another order)
SSD_BWD_FP32_TOL = 1e-4


def _ssd_cotangents(B, S, H, P, N, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn((B, S, H, P), generator=g, device=device).to(dtype),
            torch.randn((B, H, P, N), generator=g, device=device))


def _plain_ssd_grads(args, dy, dh, chunk):
    """The plain version's gradient: autograd through ref.ssd_chunked in
    fp32 on the upcast inputs."""
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    with torch.enable_grad():
        leaves = [a.detach().float().requires_grad_() for a in args]
        y, h = ssd_chunked(*leaves, chunk)
        outs, cots = ((y,), (dy.float(),)) if dh is None else \
            ((y, h), (dy.float(), dh))
        return torch.autograd.grad(outs, leaves, cots)


def _assert_ssd_grads(got, args, dy, dh, chunk):
    """fp32: each gradient within SSD_BWD_FP32_TOL of the plain version's.
    bf16: the flash backward's two gates, each gradient against the plain
    backward passes with the rounding of the kernel that bwd_path picks
    (ref.ssd_passes_bwd, operand_dtype bf16, that path) by grad_row_err,
    and against the exact gradient (the same in fp32 without rounding) by
    grad_rms_err within BF16_GRAD_RMS_RATIO of the plain version's own."""
    import importlib

    from repro_torch.kernels.flash_attention.ref import (
        BF16_GRAD_RMS_RATIO, BF16_GRAD_ROW_TOL, grad_rms_err, grad_row_err,
    )
    from repro_torch.kernels.ssd_scan.ref import ssd_passes_bwd
    K = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")

    for g, a in zip(got, args):
        assert g.shape == a.shape and g.dtype == a.dtype
        assert torch.isfinite(g).all()
    if args[0].dtype == torch.float32:
        for name, g, w in zip(SSD_GRAD_NAMES, got,
                              _plain_ssd_grads(args, dy, dh, chunk)):
            assert _grad_err(g, w) < SSD_BWD_FP32_TOL, name
        return
    up = [a.float() for a in args]
    plain = ssd_passes_bwd(*args, dy, dh, chunk,
                           operand_dtype=torch.bfloat16,
                           path=K.bwd_path(args[0], args[3], args[4], dy,
                                           chunk))
    exact = ssd_passes_bwd(*up, dy.float(), dh, chunk)
    for name, g, p, e in zip(SSD_GRAD_NAMES, got, plain, exact):
        assert grad_row_err(g, p) <= BF16_GRAD_ROW_TOL, name
        assert grad_rms_err(g, e) <= BF16_GRAD_RMS_RATIO * max(
            grad_rms_err(p, e), 1e-30), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [8, 64, 256])
@pytest.mark.parametrize("P,N", [(16, 16), (64, 128)])
@pytest.mark.parametrize("dh_final", ["none", "random"])
def test_ssd_backward_equals_plain_version(cuda, ieee_fp32, dtype, chunk, P,
                                           N, dh_final):
    """The backward kernel's six gradients against the plain version's
    (_assert_ssd_grads) from the forward's own statistics, one launch
    counted, with dh_final None (the training path) or random."""
    import importlib
    K = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")

    B, H = {8: (1, 2), 64: (2, 5), 256: (1, 6)}[chunk]
    S = 8 * chunk if chunk < 64 else 3 * chunk
    args = _ssd_inputs(B, S, H, P, N, dtype, cuda, seed=7)
    dy, dh = _ssd_cotangents(B, S, H, P, N, dtype, cuda, seed=7)
    dh = None if dh_final == "none" else dh
    _, _, h_before = K.scan(*args, chunk=chunk, stats=True)
    K.reset_launches()
    got = K.scan_bwd(*args, dy, dh, h_before, chunk=chunk)
    torch.cuda.synchronize()
    assert K.bwd_launches == {"ssd_scan_bwd": 1}
    assert K.launches == {"ssd_scan": 0}
    _assert_ssd_grads(got, args, dy, dh, chunk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_passes_equal_plain_versions(cuda, ieee_fp32, dtype):
    """Each pass of the simple backward (path="simple", which bf16 at these
    widths would not take by the rule) against its plain version (ref.py)
    on the kernel's own inputs to it: the chunk totals and dS of passes (a)
    and (b) from the scan's inputs; pass (c)'s per-head parts of dB and dC
    and per-chunk parts of dA and dD from the kernel's dS; 1e-4 of the
    largest magnitude."""
    import importlib

    from repro_torch.kernels.ssd_scan import ref
    K = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")

    B, S, H, P, N, chunk = 2, 512, 3, 64, 128, 128
    args = _ssd_inputs(B, S, H, P, N, dtype, cuda, seed=8)
    dy, dh = _ssd_cotangents(B, S, H, P, N, dtype, cuda, seed=8)
    _, _, h_before = K.scan(*args, chunk=chunk, stats=True)
    out = K.scan_bwd(*args, dy, dh, h_before, chunk=chunk, keep=True,
                     path="simple")
    torch.cuda.synchronize()
    up = [a.float() for a in args]
    dh_y, chunk_sum = ref.state_grad_from_y(dy, up[1], up[2], up[4], chunk)
    assert _rel(out["chunk_sum"], chunk_sum) < 1e-4
    assert _rel(out["dstates"], ref.state_pass_bwd(dh_y, chunk_sum, dh)) \
        < 1e-4
    parts = ref.chunk_bwd(*up, h_before, out["dstates"], dy, chunk)
    for name in ("dB_heads", "dC_heads", "dA_part", "dD_part"):
        assert _rel(out[name], parts[name]) < 1e-4, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_is_deterministic(cuda, dtype):
    """Two launches on the same inputs give the same bits (no atomics;
    the sums over heads and over chunks in a fixed order), on either path
    (bf16 here takes the wgmma backward, fp32 the simple one)."""
    import importlib
    K = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")

    args = _ssd_inputs(2, 1024, 48, 64, 128, dtype, cuda, seed=9)
    dy, dh = _ssd_cotangents(2, 1024, 48, 64, 128, dtype, cuda, seed=9)
    _, _, h_before = K.scan(*args, chunk=256, stats=True)
    K.reset_launches()
    a = K.scan_bwd(*args, dy, dh, h_before, chunk=256)
    b = K.scan_bwd(*args, dy, dh, h_before, chunk=256)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    path = "wgmma" if dtype == torch.bfloat16 else "simple"
    assert K.bwd_path_launches[path] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_strided_and_unaligned_views(cuda, ieee_fp32, dtype):
    """x, B and C as slices of one buffer, x starting 4 bytes in, dt a
    strided slice and dy transposed in memory, at widths whose rows are not
    whole 16-byte vectors (P 12, N 20): the plain version's gradients, as
    from contiguous copies."""
    import importlib
    K = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")

    B, S, H, P, N, chunk = 2, 128, 3, 12, 20, 32
    args = _ssd_inputs(B, S, H, P, N, dtype, cuda, seed=10)
    flat = torch.zeros((B, S, 2 + H * P + 2 * N), dtype=dtype, device=cuda)
    flat[..., 2:2 + H * P] = args[0].reshape(B, S, H * P)
    flat[..., 2 + H * P:2 + H * P + N] = args[3]
    flat[..., 2 + H * P + N:] = args[4]
    x = flat[..., 2:2 + H * P].view(B, S, H, P)
    Bc, Cc = flat[..., 2 + H * P:2 + H * P + N], flat[..., 2 + H * P + N:]
    dt = torch.cat([args[1], args[1]], dim=-1)[..., :H]
    assert x.data_ptr() % 16 and not dt.is_contiguous()
    dy, dh = _ssd_cotangents(B, S, H, P, N, dtype, cuda, seed=10)
    dy_t = dy.transpose(1, 2).contiguous().transpose(1, 2)
    views = [x, dt, args[2], Bc, Cc, args[5]]
    _, _, h_before = K.scan(*views, chunk=chunk, stats=True)
    got = K.scan_bwd(*views, dy_t, dh, h_before, chunk=chunk)
    want = K.scan_bwd(*(a.contiguous() for a in views), dy, dh, h_before,
                      chunk=chunk)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _assert_ssd_grads(got, args, dy, dh, chunk)


def test_ssd_backward_rejects_bad_inputs(cuda):
    import importlib
    K = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")

    args = _ssd_inputs(1, 64, 2, 16, 16, torch.bfloat16, cuda)
    dy, dh = _ssd_cotangents(1, 64, 2, 16, 16, torch.bfloat16, cuda)
    _, _, hb = K.scan(*args, chunk=16, stats=True)
    with pytest.raises(TypeError):
        K.scan_bwd(*args, dy.float(), dh, hb, chunk=16)
    with pytest.raises(TypeError):
        K.scan_bwd(*args, dy, dh.bfloat16(), hb, chunk=16)
    with pytest.raises(TypeError):
        K.scan_bwd(*args, dy, dh, hb.bfloat16(), chunk=16)
    with pytest.raises(ValueError, match="shape"):
        K.scan_bwd(*args, dy[:, :32], dh, hb, chunk=16)
    with pytest.raises(ValueError, match="contiguous last"):
        K.scan_bwd(*args, dy.transpose(2, 3).contiguous().transpose(2, 3),
                   dh, hb, chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        K.scan_bwd(*args, dy, dh.transpose(2, 3), hb, chunk=16)
    with pytest.raises(ValueError, match="shape"):
        K.scan_bwd(*args, dy, dh, hb[:, :2], chunk=16)
    with pytest.raises(ValueError):
        K.scan_bwd(*args, dy.cpu(), dh, hb, chunk=16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        K.scan_bwd(*args, dy, dh, hb, chunk=48)


@pytest.mark.parametrize("B, S, H", [(0, 64, 4), (1, 0, 4), (1, 64, 0)])
def test_ssd_backward_of_an_empty_call_launches_nothing(cuda, B, S, H):
    """An empty batch, sequence or head axis: scan_bwd gives zero
    gradients of the inputs' shapes and launches nothing, so it counts
    nothing."""
    import importlib
    K = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")

    args = [torch.ones(shape, device=cuda) for shape in (
        (B, S, H, 8), (B, S, H), (H,), (B, S, 16), (B, S, 16), (H,))]
    dy = torch.zeros((B, S, H, 8), device=cuda)
    h_before = torch.zeros((B, S // 16, H, 8, 16), device=cuda)
    K.reset_launches()
    got = K.scan_bwd(*args, dy, None, h_before, chunk=16)
    assert K.bwd_launches == {"ssd_scan_bwd": 0}
    for g, a in zip(got, args):
        assert g.shape == a.shape and not g.any()


@pytest.mark.parametrize("chunk", [64, 128, 256])
@pytest.mark.parametrize("H", [48, 2, 7])
@pytest.mark.parametrize("dh_final", ["none", "random"])
def test_ssd_wgmma_backward_equals_plain_version(cuda, ieee_fp32, chunk, H,
                                                 dh_final):
    """The wgmma backward at mamba2-780m's widths (P 64, N 128) with 48
    heads, 2 and 7 (a count no power of two divides), chunks 64, 128 and
    256, dh_final None or random: one launch on the wgmma path, and the
    six gradients within the bf16 gates of its mirrored plain version
    (_assert_ssd_grads)."""
    import importlib
    K = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")

    B, S = (1, 4 * chunk) if H == 48 else (2, 3 * chunk)
    args = _ssd_inputs(B, S, H, 64, 128, torch.bfloat16, cuda, seed=13)
    dy, dh = _ssd_cotangents(B, S, H, 64, 128, torch.bfloat16, cuda,
                             seed=13)
    dh = None if dh_final == "none" else dh
    _, _, h_before = K.scan(*args, chunk=chunk, stats=True)
    assert K.bwd_path(args[0], args[3], args[4], dy, chunk) == "wgmma"
    K.reset_launches()
    got = K.scan_bwd(*args, dy, dh, h_before, chunk=chunk)
    torch.cuda.synchronize()
    assert K.bwd_launches == {"ssd_scan_bwd": 1}
    assert K.bwd_path_launches == {"wgmma": 1, "simple": 0}
    _assert_ssd_grads(got, args, dy, dh, chunk)


def test_ssd_wgmma_backward_passes_equal_plain_versions(cuda, ieee_fp32):
    """The wgmma backward's scratch (keep=True) against the plain versions
    on the kernels' own inputs: the chunk totals, acs, dt and tail rows;
    dh_y from the rounded exp(acs) dy (ref.state_grad_from_y with bf16) and
    dS (the reverse state pass) in bf16, within one bf16 step of the
    largest magnitude (4e-3); h_before's bf16 copy; the
    head-summed dCB of each tile pair (ref.chunk_bwd_summed's dcb, as the
    kernel's hi and lo bf16 terms, whose sum keeps 16 bits: 1e-4); the
    per-chunk parts of dA and dD; 1e-3 of the largest magnitude (fp32
    sums in other orders, and a bf16 operand rounding the other side can
    take one step away)."""
    import importlib

    from repro_torch.kernels.ssd_scan import ref
    K = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")

    B, S, H, chunk = 2, 512, 3, 256
    args = _ssd_inputs(B, S, H, 64, 128, torch.bfloat16, cuda, seed=14)
    dy, dh = _ssd_cotangents(B, S, H, 64, 128, torch.bfloat16, cuda,
                             seed=14)
    _, _, h_before = K.scan(*args, chunk=chunk, stats=True)
    out = K.scan_bwd(*args, dy, dh, h_before, chunk=chunk, keep=True)
    torch.cuda.synchronize()
    assert set(out) == set(K.BWD_WGMMA_BUFFERS[9:])
    up = [a.float() for a in args]
    dh_y, chunk_sum = ref.state_grad_from_y(dy, up[1], up[2], up[4], chunk,
                                            torch.bfloat16)
    assert _rel(out["chunk_sum"], chunk_sum) < 1e-5
    acs = ref.chunk_cumsum(up[1], up[2], chunk).permute(0, 2, 1, 3)
    assert _rel(out["acs"], acs) < 1e-5
    assert torch.equal(out["dts"],
                       up[1].reshape(B, S // chunk, chunk, H).transpose(2, 3))
    tail = torch.exp(acs[..., -1:] - acs) * out["dts"]
    assert _rel(out["tail"], tail) < 1e-5
    assert _rel(out["dstates"], dh_y) < 1e-3
    dstates = ref.state_pass_bwd(dh_y, chunk_sum, dh)
    assert _rel(out["ds_bf"].float(), dstates) < 4e-3
    assert torch.equal(out["h_bf"], h_before.bfloat16())
    parts = ref.chunk_bwd_summed(*up, h_before, dstates, dy, chunk,
                                 torch.bfloat16)
    nt = chunk // 64
    for t in range(nt):
        for s in range(t + 1):
            want = parts["dcb"][:, :, 64 * t:64 * t + 64, 64 * s:64 * s + 64]
            hi, lo = out["dcb"][:, :, t * (t + 1) // 2 + s].unbind(2)
            assert _rel(hi.float(), want) < 1e-2, (t, s)
            assert _rel(hi.float() + lo.float(), want) < 1e-4, (t, s)
    for name in ("dA_part", "dD_part"):
        assert _rel(out[name], parts[name]) < 1e-3, name


def test_ssd_backward_paths_by_the_rule(cuda, ieee_fp32):
    """At mamba2-780m's widths an fp32 call, a bf16 call on an unaligned x
    view and a bf16 call whose dy is expanded over the sequence take the
    simple kernels by bwd_path's rule (counted there, none on wgmma), and
    their gradients pass the gates of that path's plain version; an
    aligned bf16 call takes wgmma.  Forcing wgmma where the rule says
    simple raises."""
    import importlib
    K = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")

    B, S, H, chunk = 1, 512, 4, 256
    for case in ("fp32", "unaligned x", "expanded dy", "aligned"):
        dtype = torch.float32 if case == "fp32" else torch.bfloat16
        args = _ssd_inputs(B, S, H, 64, 128, dtype, cuda, seed=15)
        dy, dh = _ssd_cotangents(B, S, H, 64, 128, dtype, cuda, seed=15)
        if case == "unaligned x":
            wide = torch.zeros((B, S, H * 64 + 2), dtype=dtype, device=cuda)
            wide[..., 2:] = args[0].reshape(B, S, H * 64)
            args[0] = wide[..., 2:].view(B, S, H, 64)
        elif case == "expanded dy":
            dy = dy[:, :1].expand(B, S, H, 64)
        want = "wgmma" if case == "aligned" else "simple"
        assert K.bwd_path(args[0], args[3], args[4], dy, chunk) == want
        _, _, h_before = K.scan(*args, chunk=chunk, stats=True)
        K.reset_launches()
        got = K.scan_bwd(*args, dy, dh, h_before, chunk=chunk)
        torch.cuda.synchronize()
        assert K.bwd_path_launches == {"wgmma": int(want == "wgmma"),
                                       "simple": int(want == "simple")}
        _assert_ssd_grads(got, args, dy, dh, chunk)
        if want == "simple":
            with pytest.raises(ValueError, match="does not tile"):
                K.scan_bwd(*args, dy, dh, h_before, chunk=chunk,
                           path="wgmma")


@pytest.mark.parametrize("B, S, H", [(0, 256, 4), (1, 0, 4), (1, 256, 0)])
def test_ssd_wgmma_backward_of_an_empty_call_launches_nothing(cuda, B, S, H):
    """bf16 at mamba2-780m's widths with an empty batch, sequence or head
    axis: zero gradients of the inputs' shapes, no launch on either
    path."""
    import importlib
    K = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")

    bf = torch.bfloat16
    args = [torch.ones(shape, device=cuda, dtype=bf) for shape in (
        (B, S, H, 64), (B, S, H), (H,), (B, S, 128), (B, S, 128), (H,))]
    dy = torch.zeros((B, S, H, 64), device=cuda, dtype=bf)
    h_before = torch.zeros((B, S // 256, H, 64, 128), device=cuda)
    K.reset_launches()
    got = K.scan_bwd(*args, dy, None, h_before, chunk=256)
    assert K.bwd_launches == {"ssd_scan_bwd": 0}
    assert K.bwd_path_launches == {"wgmma": 0, "simple": 0}
    for g, a in zip(got, args):
        assert g.shape == a.shape and g.dtype == a.dtype and not g.any()


def test_ssd_wgmma_backward_of_an_expanded_gradient_through_autograd(
        cuda, ieee_fp32):
    """y.sum() hands SSDScan an expanded dy (every stride 0); the backward
    copies it to a layout TMA maps and takes the wgmma path, with the
    gradients of the mirrored plain version."""
    from repro_torch.kernels import ssd_scan as SS

    args = _ssd_inputs(1, 512, 4, 64, 128, torch.bfloat16, cuda, seed=16)
    leaves = [a.detach().clone().requires_grad_() for a in args]
    y, _ = SS.ssd_scan(*leaves, chunk=256)
    SS.reset_launches()
    y.sum().backward()
    assert SS.bwd_path_launches == {"wgmma": 1, "simple": 0}
    _assert_ssd_grads([t.grad for t in leaves], args, torch.ones_like(y),
                      None, 256)


def test_mamba2_train_step_takes_the_wgmma_backward(cuda):
    """mamba2-780m at full width and depth (48 layers, bf16 compute),
    tokens [1, 256]: the loss and its gradient through the port's loss_fn
    launch SSDScan's backward once per layer, every call on the wgmma
    path; the loss and every gradient leaf are finite."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim.adamw import tree_leaves, tree_unflatten

    cfg = get_config("mamba2-780m")
    params = init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 257)).astype(np.int32)).to(cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    SS.reset_launches()
    loss, _ = loss_fn(tree_unflatten(params, leaves), batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    assert SS.bwd_launches == {"ssd_scan_bwd": cfg.n_layers}
    assert SS.bwd_path_launches == {"wgmma": cfg.n_layers, "simple": 0}
    assert torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_forward_statistics_leave_the_scan_bitwise(cuda, dtype):
    """scan(stats=True) writes the fp32 state before each chunk (the plain
    version's, 1e-5 of the largest) and gives the same y and h_final bits
    as the call without statistics, on both paths (bf16 at mamba2-780m's
    widths takes the wgmma passes, fp32 the simple kernel)."""
    import importlib

    from repro_torch.kernels.ssd_scan import ref
    K = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")

    args = _ssd_inputs(2, 1024, 48, 64, 128, dtype, cuda, seed=11)
    y0, h0 = K.scan(*args, chunk=256)
    y1, h1, h_before = K.scan(*args, chunk=256, stats=True)
    assert torch.equal(y0, y1) and torch.equal(h0, h1)
    bf = dtype == torch.bfloat16
    states, chunk_sum = ref.chunk_state(*(a.float() for a in args[:4]), 256,
                                        torch.bfloat16 if bf else None)
    want, _ = ref.state_pass(states, chunk_sum)
    assert h_before.dtype == torch.float32
    assert _rel(h_before, want) < (1e-2 if bf else 1e-5)


def test_ssd_backward_through_autograd(cuda, ieee_fp32):
    """ssd_scan with inputs that need a gradient records SSDScan: the
    forward launches once with statistics, backward() launches the
    backward kernel once and gives the plain version's gradients (y alone,
    then y and h_final); a second derivative raises; under no_grad the
    forward runs alone."""
    from repro_torch.kernels import ssd_scan as SS

    args = _ssd_inputs(1, 256, 4, 64, 128, torch.float32, cuda, seed=12)
    dy, dh = _ssd_cotangents(1, 256, 4, 64, 128, torch.float32, cuda,
                             seed=12)
    for use_h in (False, True):
        leaves = [a.detach().clone().requires_grad_() for a in args]
        SS.reset_launches()
        y, h = SS.ssd_scan(*leaves, chunk=64)
        assert type(y.grad_fn).__name__ == "SSDScanBackward"
        (y * dy).sum().add((h * dh).sum() if use_h else 0).backward()
        assert SS.launches == {"ssd_scan": 1}
        assert SS.bwd_launches == {"ssd_scan_bwd": 1}
        _assert_ssd_grads([t.grad for t in leaves], args, dy,
                          dh if use_h else None, 64)
    leaves = [a.detach().clone().requires_grad_() for a in args]
    y, _ = SS.ssd_scan(*leaves, chunk=64)
    dx, = torch.autograd.grad(y.square().sum(), leaves[0],
                              create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dx.sum().backward()
    with torch.no_grad():
        y, _ = SS.ssd_scan(*leaves, chunk=64)
    assert y.grad_fn is None


# ---------------------------------------------------------------------------
# dvv_ops: the tiled and general paths, and the staged front ends
# ---------------------------------------------------------------------------

#: chip_smoke.py's KERNEL_SHAPES, then the tiled path's edges (K and R in
#: 1..8; one past on either side goes the general path), ragged tiles (N
#: not a multiple of 32 or 64) and the store's own widths (K <= 4, R 5).
TILED_SHAPES = [(64, 2, 8), (4096, 4, 8), (16384, 4, 8), (1048576, 8, 8),
                (1, 1, 1), (33, 8, 8), (65, 9, 8), (65, 8, 9), (100, 1, 1),
                (129, 5, 7), (4095, 3, 5), (8447, 2, 5), (8449, 4, 5),
                (70000, 3, 3)]


def _general_sweeps(on_card):
    """Mask, read-sweep mask and ceilings from the general kernels, called
    through the C dispatch whatever path the wrappers take at the shape."""
    from repro_torch.kernels.dvv_ops import dvv_ops as C

    N, K, R = on_card[0].shape
    dev = on_card[0].device
    mask = torch.empty((N, K), dtype=torch.bool, device=dev)
    smask = torch.empty_like(mask)
    ceil = torch.empty((N, R), dtype=torch.int64, device=dev)
    lib, stream = C._load(), C.stream_of(dev)
    ins = [t.data_ptr() for t in on_card]
    for out, cptr in ((mask, None), (smask, ceil.data_ptr())):
        assert lib.dvv_sweep_launch(*ins, out.data_ptr(), cptr, N, K, R, 0,
                                    stream) == 0
    return mask, smask, ceil


@pytest.mark.parametrize("shape", TILED_SHAPES)
def test_sweeps_equal_plain_versions_on_both_paths(cuda, shape):
    """Mask and ceilings exactly equal to the plain version through the
    wrappers, which take the tiled path where it takes the shape, and
    through the general kernels at the same shape."""
    from repro_torch.kernels.dvv_ops import dvv_ops as C

    on_card = _t(_grouped(*shape, seed=sum(shape)), cuda)
    want_mask, want_ceil = ref.read_sweep_ref(*on_card)
    C.reset_launches()
    mask = C.sync_mask(*on_card)
    smask, ceil = C.read_sweep(*on_card)
    assert C.path_launches[C.tiled_path(*shape)] == 2
    gmask, gsmask, gceil = _general_sweeps(on_card)
    torch.cuda.synchronize()
    for got in (mask, smask, gmask, gsmask):
        assert torch.equal(got, want_mask)
    assert torch.equal(ceil, want_ceil) and torch.equal(gceil, want_ceil)


def test_sweeps_of_unaligned_views_take_the_general_path(cuda):
    from repro_torch.kernels.dvv_ops import dvv_ops as C

    args = _t(_grouped(101, 3, 5, seed=9), cuda)
    views = [a[1:] for a in args]                 # 60 and 12 bytes in
    assert views[0].data_ptr() % 16 and views[3].data_ptr() % 16
    C.reset_launches()
    mask, ceil = C.read_sweep(*views)
    want_mask, want_ceil = ref.read_sweep_ref(*views)
    assert torch.equal(mask, want_mask) and torch.equal(ceil, want_ceil)
    assert C.path_launches == {"tiled": 0, "general": 1}


@pytest.mark.parametrize("shape", [(29, 2, 5), (1000, 4, 5), (8000, 2, 5),
                                   (1, 300, 0), (7, 300, 2), (1000, 9, 0)])
def test_staged_front_ends_equal_numpy_twin(cuda, shape):
    """numpy in, numpy out through the pinned staging buffer: exactly the
    numpy twin, with one copy in and one copy out per sweep."""
    args = _grouped(*shape, seed=len(shape) + shape[0])
    want = TB.sync_mask_np(*args)
    fronts = (ops.BucketedSweep(cuda), ops.BucketedReadSweep(cuda))
    np.testing.assert_array_equal(fronts[0](*args), want)
    mask, ceil = fronts[1](*args)
    np.testing.assert_array_equal(mask, want)
    for n in range(min(shape[0], 64)):
        s = np.flatnonzero(want[n])
        np.testing.assert_array_equal(ceil[n], TB.grouped_ceiling_np(
            args[0][n][s], args[1][n][s], args[2][n][s],
            np.zeros(len(s), np.int64), 1)[0])
    for f in fronts:
        assert f._host.is_pinned()
        assert f.h2d_copies == f.d2h_copies == 1


def test_cluster_front_ends_copy_once_each_way_per_sweep(cuda):
    """The store's planes on the card: every sweep of either front end is
    one H2D and one D2H copy (the front ends' counters) and one launch."""
    fronts = (ops.dvv_sync_mask_bucketed(cuda),
              ops.dvv_read_sweep_bucketed(cuda))
    before = [(f.hits + f.misses, f.h2d_copies, f.d2h_copies)
              for f in fronts]
    ops.reset_launches()
    c = KVCluster(("a", "b", "c"), DVV_MECHANISM, replication=2,
                  read_quorum=2, shards=2)
    cl = KVClient(c, "t", via="a")
    keys = [f"k{i}" for i in range(200)]
    cl.put_many({k: (k, None) for k in keys})
    c.deliver_replication()
    c.delta_antientropy_round()
    got = cl.get_many(keys)
    assert all(got[k].values == (k,) for k in keys)
    sweeps = []
    for f, (n0, h0, d0) in zip(fronts, before):
        n = f.hits + f.misses - n0
        assert n > 0 and f.h2d_copies - h0 == n and f.d2h_copies - d0 == n
        sweeps.append(n)
    assert ops.launches["dvv_sync_mask"] == sweeps[0]
    assert ops.launches["dvv_read_sweep"] == sweeps[1]


# ---------------------------------------------------------------------------
# flash_attention: masks by position
# ---------------------------------------------------------------------------

def _flash_positions(S):
    """Position vectors of length S: an image's patches sharing one
    temporal id between text runs, a shuffled order with repeats, a
    descending order, and gaps."""
    text = S // 8
    rng = np.random.default_rng(S)
    return {
        "repeated": np.concatenate([np.arange(text), np.full(S // 2, text),
                                    np.arange(text + 1,
                                              text + 1 + S - text - S // 2)]),
        "shuffled": rng.permutation(S) // 3,
        "descending": S - 1 - np.arange(S),
        "gaps": np.arange(S) * 7 - 1000,
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("which", ["repeated", "shuffled", "descending",
                                   "gaps"])
@pytest.mark.parametrize("mode", ["causal", "window", "window_softcap",
                                  "bidir"])
def test_flash_kernel_with_positions_equals_plain_version(
        cuda, ieee_fp32, dtype, D, which, mode):
    """S = 320 (ragged 128-row q tiles and 80-key tiles): masks by the
    positions, the plain version's result at the existing tolerances."""
    q, k, v = _qkv(2, 320, 4, 2, D, dtype, cuda, seed=7)
    pos = torch.from_numpy(_flash_positions(320)[which].astype(
        np.int32)).to(cuda)
    kw = dict(FLASH_MODES[mode], positions=pos)
    FA.reset_launches()
    got = FA.gqa_flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, **kw)
    assert FA.launches == {"flash_attention": 1}
    assert torch.isfinite(got).all()
    _assert_flash_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [100, 4160])
@pytest.mark.parametrize("mode", ["causal", "window_softcap", "bidir"])
def test_flash_kernel_arange_positions_equal_index_masks_bitwise(
        cuda, dtype, S, mode):
    """positions 0..S-1 take the same tiles and masks as the index
    instance: bitwise-equal outputs."""
    q, k, v = _qkv(1, S, 4, 2, 128, dtype, cuda, seed=8)
    pos = torch.arange(S, dtype=torch.int32, device=cuda)
    a = FA.gqa_flash_attention(q, k, v, **FLASH_MODES[mode])
    b = FA.gqa_flash_attention(q, k, v, positions=pos, **FLASH_MODES[mode])
    assert torch.equal(a, b)


def test_flash_kernel_index_masks_bitwise_equal_to_parent_build(cuda):
    """positions=None against a build of the parent commit's kernel source
    (saved as build/flash_attention_parent.cu, or FLASH_BASELINE_CU): the
    index instance compiles as before, so the outputs are bitwise equal."""
    import os
    import shutil
    from pathlib import Path

    from repro_torch.kernels import build as _build
    from repro_torch.kernels.flash_attention import flash_attention as K

    src = Path(os.environ.get("FLASH_BASELINE_CU", _build.BUILD_ROOT.parent
                              / "flash_attention_parent.cu"))
    if not src.exists():
        pytest.skip(f"needs the parent commit's kernel source at {src}")
    csrc = _build.BUILD_ROOT / "flash_attention_parent_src"
    shutil.rmtree(csrc, ignore_errors=True)
    csrc.mkdir(parents=True)
    shutil.copyfile(src, csrc / "flash_attention.cu")
    parent = K.load(_build.build("flash_attention_parent", csrc))
    for dtype, S, D in ((torch.bfloat16, 4160, 256), (torch.bfloat16, 320, 64),
                        (torch.float32, 320, 128)):
        q, k, v = _qkv(1, S, 4, 2, D, dtype, cuda, seed=9)
        for mode in FLASH_MODES:
            assert torch.equal(K.attend(q, k, v, **FLASH_MODES[mode]),
                               K.attend(q, k, v, lib=parent,
                                        **FLASH_MODES[mode])), (dtype, mode)


def _parent_build(name, env, default, files):
    """The path of a library built from the parent commit's sources
    (``files``: their names under build/``default`` or ``$env``); the
    test skips without them."""
    import os
    import shutil
    from pathlib import Path

    from repro_torch.kernels import build as _build

    src = Path(os.environ.get(env, _build.BUILD_ROOT.parent / default))
    if not all((src / f).exists() for f in files):
        pytest.skip(f"needs the parent commit's sources {files} in {src}")
    csrc = _build.BUILD_ROOT / f"{name}_src"
    shutil.rmtree(csrc, ignore_errors=True)
    csrc.mkdir(parents=True)
    for f in files:
        shutil.copyfile(src / f, csrc / f)
    return _build.build(name, csrc)


def test_flash_kernel_position_masks_bitwise_equal_to_parent_build(cuda):
    """The position instance and the index instance, without the
    statistics the recorded forward adds, against a build of the parent
    commit's flash_attention.cu (build/flash_attention_parent/, or
    $FLASH_PARENT_DIR): bitwise equal outputs."""
    from repro_torch.kernels.flash_attention import flash_attention as K

    parent = K.load(_parent_build("flash_attention_parent2",
                                  "FLASH_PARENT_DIR",
                                  "flash_attention_parent",
                                  ["flash_attention.cu"]))
    for dtype, S, D in ((torch.bfloat16, 4160, 256), (torch.bfloat16, 320, 64),
                        (torch.float32, 320, 128)):
        q, k, v = _qkv(1, S, 4, 2, D, dtype, cuda, seed=9)
        pos = torch.from_numpy(_flash_positions(S)["repeated"].astype(
            np.int32)).to(cuda)
        for mode in ("causal", "window_softcap", "bidir"):
            for p in (None, pos):
                assert torch.equal(
                    K.attend(q, k, v, positions=p, **FLASH_MODES[mode]),
                    K.attend(q, k, v, positions=p, lib=parent,
                             **FLASH_MODES[mode])), (dtype, mode, p is None)


@pytest.mark.parametrize("D", [64, 80, 128, 256])
@pytest.mark.parametrize("mode", ["causal", "window_softcap", "bidir",
                                  "positions"])
def test_flash_forward_statistics_equal_plain_version(cuda, ieee_fp32, D,
                                                      mode):
    """attend(stats=True): the same bf16 output as without statistics, the
    fp32 output it rounds from (bitwise its source; within BF16_ROW_TOL
    of the plain version's fp32 output, whose p rounds against the final
    maximum and not the running one) and each row's logsumexp within 1e-4
    of the plain version's relative to max(1, |lse|) (fp32 sums in another
    order, ex2.approx)."""
    from repro_torch.kernels.flash_attention import flash_attention as K
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_stats_ref,
    )

    q, k, v = _qkv(2, 200, 4, 2, D, torch.bfloat16, cuda, seed=14)
    kw = dict(FLASH_MODES["causal" if mode == "positions" else mode])
    if mode == "positions":
        kw["positions"] = torch.from_numpy(_flash_positions(200)[
            "shuffled"].astype(np.int32)).to(cuda)
    K.reset_launches()
    out, lse, out32 = K.attend(q, k, v, stats=True, **kw)
    torch.cuda.synchronize()
    assert K.launches["flash_attention"] == 1
    assert torch.equal(out, K.attend(q, k, v, **kw))
    assert torch.equal(out, out32.to(torch.bfloat16))
    want32, want_lse = flash_attention_stats_ref(q, k, v, **kw)
    assert lse.shape == (2, 4, 200) and out32.shape == (2, 200, 4, D)
    assert float(((lse - want_lse).abs() / want_lse.abs().clamp_min(1.0))
                 .max()) < 1e-4
    assert row_scaled_err(out32, want32) < BF16_ROW_TOL


@pytest.mark.parametrize("mode", ["causal", "window_softcap", "positions"])
def test_flash_backward_with_and_without_lse_is_bitwise_equal(cuda, mode):
    """attend_bwd given the recorded forward's statistics and attend_bwd
    recomputing them by one forward launch give the same bits."""
    from repro_torch.kernels.flash_attention import flash_attention as K

    q, k, v = _qkv(1, 320, 8, 2, 128, torch.bfloat16, cuda, seed=15)
    dout = _qkv(1, 320, 8, 1, 128, torch.bfloat16, cuda, seed=16)[0]
    kw = dict(FLASH_MODES["causal" if mode == "positions" else mode])
    if mode == "positions":
        kw["positions"] = torch.from_numpy(_flash_positions(320)[
            "repeated"].astype(np.int32)).to(cuda)
    out, lse, out32 = K.attend(q, k, v, stats=True, **kw)
    given = K.attend_bwd(q, k, v, out, dout, lse=lse, out32=out32, **kw)
    again = K.attend_bwd(q, k, v, out, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(given, again))


def test_flash_wrapper_rejects_bad_positions(cuda):
    q, k, v = _qkv(1, 64, 4, 2, 64, torch.bfloat16, cuda)
    pos = torch.arange(64, dtype=torch.int32, device=cuda)
    for bad in (pos.long(), pos[:32], pos.cpu(), pos.repeat(2)[::2]):
        with pytest.raises(ValueError, match="positions"):
            FA.gqa_flash_attention(q, k, v, positions=bad)
    with pytest.raises(ValueError, match="positions"):
        FA.gqa_flash_attention(q, k[:, :32], v[:, :32], positions=pos)


def test_mrope_prefill_on_the_card_masks_by_position(cuda, ieee_fp32):
    """qwen2-vl-7b's smoke config with head_dim 64, fp32, image-style
    M-RoPE positions: logits on the card equal the CPU run's (which the
    CPU twins hold to the JAX package's default path)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_params

    cfg = replace(get_config("qwen2-vl-7b").smoke(), head_dim=64,
                  compute_dtype="float32")
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(0)
    emb = torch.from_numpy(rng.normal(size=(2, 160, cfg.d_model)).astype(
        np.float32))
    t = np.concatenate([np.arange(16), np.full(64, 16), np.arange(17, 97)])
    h, w = t.copy(), t.copy()
    h[16:80] = 16 + np.arange(64) // 8
    w[16:80] = 16 + np.arange(64) % 8
    pos = torch.from_numpy(np.broadcast_to(
        np.stack([t, h, w])[:, None], (3, 2, 160)).astype(np.int32))
    prefill = make_prefill_step(cfg)
    want = prefill(params, {"embeddings": emb, "positions": pos})
    index = prefill(params, {"embeddings": emb})
    FA.reset_launches()
    got = prefill(_to(params, cuda), {"embeddings": emb.to(cuda),
                                      "positions": pos.to(cuda)})
    torch.cuda.synchronize()
    assert FA.launches["flash_attention"] == cfg.n_layers
    assert float((got.cpu() - want).abs().max()) < 1e-4
    assert float((index - want).abs().max()) > 1e-2   # positions count


# ---------------------------------------------------------------------------
# flash_attention: the backward kernel
# ---------------------------------------------------------------------------

#: dq, dk and dv against the plain version: max abs error over the largest
#: magnitude of the plain version's gradient, that magnitude floored at
#: 1e-2 (N(0, 1) inputs give gradients of order 0.1-10; a gradient that is
#: exactly 0, as dq with a single key, is held absolutely).  fp32 sums in
#: another order; bf16 also rounds P and dS to bf16 as wgmma operands and
#: reads delta from the forward kernel's fp32 output, whose p was rounded
#: to bf16 against the running maximum.  (A per-row scale does not fit: a
#: causal row 0's dq is 0 up to rounding.)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _grad_err(got, want):
    return float((got.float() - want.float()).abs().max() /
                 want.float().abs().max().clamp_min(1e-2))


def _bwd_case(q, k, v, seed=0, **kw):
    """(kernel's, plain version's) (dq, dk, dv) for a random dout."""
    from repro_torch.kernels.flash_attention import flash_attention as K
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref,
    )

    gen = torch.Generator(device=q.device).manual_seed(seed)
    dout = torch.randn(q.shape, generator=gen, device=q.device,
                       dtype=torch.float32).to(q.dtype)
    out = K.attend(q, k, v, **kw)
    K.reset_launches()
    got = K.attend_bwd(q, k, v, out, dout, **kw)
    torch.cuda.synchronize()
    assert K.bwd_launches == {"flash_attention_bwd": 1}
    return got, flash_attention_bwd_ref(q, k, v, out, dout, **kw)


def _assert_grads_close(got, want, q, k):
    for g, w, like in zip(got, want, (q, k, k)):
        assert g.shape == like.shape and g.dtype == like.dtype
        assert torch.isfinite(g).all()
        assert _grad_err(g, w) < BWD_TOL[g.dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 80, 128, 256])
@pytest.mark.parametrize("heads", [(16, 8), (8, 1), (4, 4)])
@pytest.mark.parametrize("mode", list(FLASH_MODES))
def test_flash_backward_equals_plain_version(cuda, ieee_fp32, dtype, D,
                                             heads, mode):
    """S = 200 (ragged 64-row q tiles and 32-key tiles); MQA (8, 1) splits
    each key tile's query heads over blocks (fp32 partials, a reduce)."""
    q, k, v = _qkv(2, 200, *heads, D, dtype, cuda)
    got, want = _bwd_case(q, k, v, **FLASH_MODES[mode])
    _assert_grads_close(got, want, q, k)


def _c_strides(*views):
    """The C entry points' strides argument: (b, s, head) of each view."""
    import ctypes
    vals = [st for t in views for st in t.stride()[:3]]
    return ctypes.cast((ctypes.c_int64 * len(vals))(*vals), ctypes.c_void_p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [(4, 4), (8, 1)])
@pytest.mark.parametrize("mode", ["causal", "bidir"])
def test_flash_kernels_never_write_past_head_dim_80(cuda, ieee_fp32, dtype,
                                                    heads, mode):
    """head_dim 80 through the C entry points with every output a view of
    the first 80 of 128 columns (the bf16 kernels' padded width), the rest
    a canary: the forward's output, the bf16 forward's fp32 output (a
    canary after its end), and dq, dk, dv (MQA (8, 1): the fp32 partials
    and their reduce) keep the canary, and agree with the plain version."""
    from repro_torch.kernels.flash_attention import flash_attention as K
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_stats_ref,
    )

    B, S, (H, KV), D, W, canary = 2, 200, heads, 80, 128, 7.0
    kw = FLASH_MODES[mode]
    q, k, v = _qkv(B, S, H, KV, D, dtype, cuda, seed=21)
    dout = _qkv(B, S, H, 1, D, dtype, cuda, seed=22)[0]
    bf16 = dtype == torch.bfloat16
    lib, stream = K._load(), torch.cuda.current_stream().cuda_stream
    scale = D ** -0.5

    def padded(heads_, dt=dtype):
        buf = torch.full((B, S, heads_, W), canary, dtype=dt, device=cuda)
        return buf, buf[..., :D]

    o_buf, o = padded(H)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H,
            KV, S, S, D, _c_strides(q, k, v, o), scale, 0.0,
            int(kw["causal"]), 0)
    lse = out32 = None
    if bf16:
        lse = torch.empty((B, H, S), dtype=torch.float32, device=cuda)
        o32_buf = torch.full((B * S * H * D + W,), canary,
                             dtype=torch.float32, device=cuda)
        out32 = o32_buf[:-W].view(B, S, H, D)
        err = lib.flash_attention_stats_launch(
            *args, None, None, lse.data_ptr(), out32.data_ptr(), stream)
    else:
        err = lib.flash_attention_launch(*args, 0, stream)
    torch.cuda.synchronize()
    assert err == 0
    assert bool((o_buf[..., D:] == canary).all())
    _assert_flash_close(o, flash_attention_ref(q, k, v, **kw))
    if bf16:
        assert bool((o32_buf[-W:] == canary).all())
        assert row_scaled_err(out32, flash_attention_stats_ref(
            q, k, v, **kw)[0]) < BF16_ROW_TOL

    (dq_buf, dq), (dk_buf, dk), (dv_buf, dv) = padded(H), padded(KV), \
        padded(KV)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    nsplit = K.kv_splits(B, KV, S, H // KV, sms, K.bwd_key_tile(dtype))
    assert (nsplit > 1) == (heads == (8, 1))
    stats = torch.empty((1 if bf16 else 3) * B * H * S, dtype=torch.float32,
                        device=cuda)
    partials = torch.empty(max(2 * nsplit * B * S * KV * D, 1),
                           dtype=torch.float32, device=cuda)
    err = lib.flash_attention_grad_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bf16 else o.data_ptr(), out32.data_ptr() if bf16 else None,
        lse.data_ptr() if bf16 else None, dout.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, H, KV, S, S, D,
        _c_strides(q, k, v, o, dout, dq, dk, dv), scale, 0.0,
        int(kw["causal"]), 0, int(bf16), None, None, stats.data_ptr(),
        partials.data_ptr(), nsplit, stream)
    torch.cuda.synchronize()
    assert err == 0
    for buf in (dq_buf, dk_buf, dv_buf):
        assert bool((buf[..., D:] == canary).all())
    want = flash_attention_bwd_ref(q, k, v, o, dout, **kw)
    _assert_grads_close((dq, dk, dv), want, q, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["repeated", "shuffled", "descending",
                                   "gaps"])
@pytest.mark.parametrize("mode", ["causal", "window_softcap", "bidir"])
def test_flash_backward_with_positions_equals_plain_version(
        cuda, ieee_fp32, dtype, which, mode):
    q, k, v = _qkv(2, 320, 4, 2, 128, dtype, cuda, seed=7)
    pos = torch.from_numpy(_flash_positions(320)[which].astype(
        np.int32)).to(cuda)
    got, want = _bwd_case(q, k, v, positions=pos, **FLASH_MODES[mode])
    _assert_grads_close(got, want, q, k)


@pytest.mark.parametrize("which", ["repeated", "shuffled"])
@pytest.mark.parametrize("mode", ["causal", "window_softcap"])
def test_flash_backward_with_positions_at_head_dim_256(cuda, ieee_fp32,
                                                       which, mode):
    """bf16 at D 256, where dq's key tiles are 48 keys and its position
    bounds are taken over 48-key chunks beside dkdv's 64-key ones."""
    q, k, v = _qkv(1, 400, 4, 2, 256, torch.bfloat16, cuda, seed=17)
    pos = torch.from_numpy(_flash_positions(400)[which].astype(
        np.int32)).to(cuda)
    got, want = _bwd_case(q, k, v, positions=pos, **FLASH_MODES[mode])
    _assert_grads_close(got, want, q, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk", [(1, 1), (33, 33), (96, 160), (160, 96)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_ragged_lengths(cuda, ieee_fp32, dtype, Sq, Sk,
                                       causal):
    q = _qkv(1, Sq, 4, 2, 64, dtype, cuda, seed=2)[0]
    _, k, v = _qkv(1, Sk, 4, 2, 64, dtype, cuda, seed=3)
    got, want = _bwd_case(q, k, v, causal=causal)
    _assert_grads_close(got, want, q, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_strided_views(cuda, ieee_fp32, dtype):
    """q, k, v as slices of one fused projection and dout transposed in
    memory: the kernel reads views by their strides."""
    from repro_torch.kernels.flash_attention import flash_attention as K
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref,
    )

    B, S, H, KV, D = 2, 192, 4, 2, 128
    x = _qkv(B, S, H + 2 * KV, 1, D, dtype, cuda, seed=5)[0]
    q, k, v = x[:, :, :H], x[:, :, H:H + KV], x[:, :, H + KV:]
    dout = _qkv(B, S, H, 1, D, dtype, cuda, seed=6)[0].transpose(
        1, 2).contiguous().transpose(1, 2)
    out = K.attend(q, k, v, causal=True)
    got = K.attend_bwd(q, k, v, out, dout, causal=True)
    want = flash_attention_bwd_ref(q, k, v, out, dout, causal=True)
    _assert_grads_close(got, want, q, k)


@pytest.mark.parametrize("shape", [(1, 1024, 8, 1, 256), (2, 2176, 16, 8, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_is_deterministic(cuda, shape, dtype):
    """Two launches on the same inputs give the same bits: MQA's split
    partials (gemma-2b's heads) and the one-split path alike."""
    from repro_torch.kernels.flash_attention import flash_attention as K

    B, S, H, KV, D = shape
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    q, k, v = _qkv(B, S, H, KV, D, dtype, cuda, seed=8)
    splits = K.kv_splits(B, KV, S, H // KV, sms, K.bwd_key_tile(dtype))
    assert (splits > 1) == (KV == 1)
    dout = _qkv(B, S, H, 1, D, dtype, cuda, seed=9)[0]
    out = K.attend(q, k, v, causal=True, softcap=50.0)
    a = K.attend_bwd(q, k, v, out, dout, causal=True, softcap=50.0)
    b = K.attend_bwd(q, k, v, out, dout, causal=True, softcap=50.0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _shifted(t):
    """A copy of ``t`` one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_backward_copies_a_misaligned_gradient(cuda, D):
    """attend_bwd refuses a view its 16-byte copies cannot read; autograd's
    FlashAttention copies such an output gradient into an aligned buffer
    and gives the same bits as for the aligned one."""
    from repro_torch.kernels.flash_attention import flash_attention as K

    q, k, v = (t.requires_grad_() for t in _qkv(1, 320, 8, 2, D,
                                                torch.bfloat16, cuda,
                                                seed=10))
    dout = _qkv(1, 320, 8, 1, D, torch.bfloat16, cuda, seed=11)[0]
    out = FA.gqa_flash_attention(q, k, v, causal=True, softcap=30.0)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.attend_bwd(q.detach(), k.detach(), v.detach(), out.detach(),
                     _shifted(dout), causal=True, softcap=30.0)
    FA.reset_launches()
    aligned = torch.autograd.grad(out, (q, k, v), dout, retain_graph=True)
    odd = torch.autograd.grad(out, (q, k, v), _shifted(dout))
    assert FA.bwd_launches == {"flash_attention_bwd": 2}
    assert all(torch.equal(a, o) for a, o in zip(aligned, odd))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_backward_with_scores_at_the_softcap(cuda, ieee_fp32, dtype, D):
    """q drawn 30 times larger puts a row's leading scores where the softcap
    of 50 bends, so 1 - (s/cap)^2 ranges from about 0.9 to 0.1: fp32 to the
    plain version's gradients; bf16 within BF16_GRAD_RMS_RATIO of the plain
    bf16 version's own distance from the exact gradient (the plain
    version in fp32 on the upcast inputs), and row by row within
    BF16_GRAD_ROW_TOL of the plain version's."""
    from repro_torch.kernels.flash_attention.ref import (
        BF16_GRAD_RMS_RATIO, BF16_GRAD_ROW_TOL, flash_attention_bwd_ref,
        grad_rms_err, grad_row_err,
    )

    q, k, v = _qkv(1, 512, 8, 2, D, torch.float32, cuda, seed=12)
    q, k, v = (t.to(dtype) for t in (q * 30.0, k, v))
    kw = dict(causal=True, softcap=50.0)
    got, want = _bwd_case(q, k, v, seed=13, **kw)
    if dtype == torch.float32:
        _assert_grads_close(got, want, q, k)
        return
    gen = torch.Generator(device=cuda).manual_seed(13)
    dout = torch.randn(q.shape, generator=gen, device=cuda,
                       dtype=torch.float32).to(dtype)
    exact = flash_attention_bwd_ref(q.float(), k.float(), v.float(), None,
                                    dout.float(), **kw)
    for g, w, e in zip(got, want, exact):
        assert torch.isfinite(g).all()
        assert grad_row_err(g, w) <= BF16_GRAD_ROW_TOL
        assert grad_rms_err(g, e) <= BF16_GRAD_RMS_RATIO * grad_rms_err(w, e)


def test_flash_backward_second_derivative_raises(cuda, ieee_fp32):
    """The backward kernel's gradients carry no graph of their own: a
    second derivative through it raises instead of reading as zero."""
    q, k, v = (t.requires_grad_() for t in _qkv(1, 128, 4, 2, 64,
                                                torch.float32, cuda))
    out = FA.gqa_flash_attention(q, k, v, causal=True)
    dq, = torch.autograd.grad(out.square().sum(), q, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dq.sum().backward()


def test_flash_backward_through_autograd(cuda, ieee_fp32):
    """gqa_flash_attention with inputs that need a gradient records
    FlashAttention: backward() launches the backward kernel once and gives
    the plain version's gradients."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    q, k, v = (t.requires_grad_() for t in _qkv(1, 256, 8, 2, 128,
                                                torch.float32, cuda))
    FA.reset_launches()
    out = FA.gqa_flash_attention(q, k, v, causal=True, softcap=30.0)
    out.square().sum().backward()
    assert FA.launches == {"flash_attention": 1}
    assert FA.bwd_launches == {"flash_attention_bwd": 1}
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    flash_attention_ref(*leaves, causal=True, softcap=30.0).square().sum(
    ).backward()
    for t, w in zip((q, k, v), leaves):
        assert _grad_err(t.grad, w.grad) < BWD_TOL[torch.float32]


def test_flash_backward_wrapper_rejects_bad_inputs(cuda):
    from repro_torch.kernels.flash_attention import flash_attention as K

    q, k, v = _qkv(1, 64, 4, 2, 64, torch.bfloat16, cuda)
    out = K.attend(q, k, v)
    for bad in (dict(dout=out.float()), dict(dout=out[:, :32]),
                dict(dout=out.transpose(2, 3)), dict(out=out.cpu())):
        args = {"out": out, "dout": out, **bad}
        with pytest.raises(ValueError):
            K.attend_bwd(q, k, v, args["out"], args["dout"])
    with pytest.raises(ValueError, match="head_dim"):
        K.attend_bwd(*(t[..., :48] for t in (q, k, v, out, out)))


def test_flash_backward_build_failure_raises(cuda, tmp_path):
    """A source nvcc refuses raises RuntimeError with the compiler's
    output; nothing falls back."""
    from repro_torch.kernels import build as _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "broken.cu").write_text(
        "extern \"C\" int broken_launch() { return undeclared_name; }\n")
    with pytest.raises(RuntimeError, match="nvcc failed") as err:
        _build.build("flash_attention_broken", csrc)
    assert "undeclared_name" in str(err.value)


def test_training_step_on_the_card_equals_the_cpu_run(cuda, ieee_fp32):
    """gemma-2b's smoke config with head_dim 64, fp32: one make_train_step
    on the card (flash forward and backward kernels) against the CPU's
    (plain versions): loss, gradient norm and parameters; one forward and
    one backward launch a layer, and a recompute with remat."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.optim.adamw import tree_leaves

    for remat in (False, True):
        cfg = replace(get_config("gemma-2b").smoke(), head_dim=64,
                      compute_dtype="float32", remat=remat)
        opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 128)).astype(np.int32))
        batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
        runs = []
        for device in ("cpu", cuda):
            params = _to(init_params(torch.Generator().manual_seed(0), cfg,
                                     device="cpu"), device)
            state = init_opt_state(params, opt)
            FA.reset_launches()
            params, state, m = make_train_step(cfg, opt)(
                params, state, {k: t.to(device) for k, t in batch.items()})
            runs.append((float(m["loss"]), float(m["grad_norm"]),
                         [p.cpu() for p in tree_leaves(params)],
                         [t.cpu() for t in tree_leaves(state["m"])],
                         dict(FA.launches), dict(FA.bwd_launches)))
        (cl, cn, cp, cm, _, _), (gl, gn, gp, gm, fwd, bwd) = runs
        assert abs(gl - cl) < 1e-4 and abs(gn - cn) < 1e-4 * max(1, cn)
        for a, b, ma, mb in zip(gp, cp, gm, cm):
            assert float((ma - mb).abs().max()) <= 1e-4 * float(
                mb.abs().max().clamp_min(1e-30))
            # Adam's first step moves an entry by lr * sign(g) where |g| is
            # far above eps and the gradients' error (tests/test_torch_
            # train.py::test_train_step_matches_jax)
            clear = mb.abs() >= 1e-7
            assert float(torch.where(clear, (a - b).abs(), 0.0).max()) < 1e-5
            assert float((a - b).abs().max()) <= 2 * opt.lr + 1e-5
        assert fwd["flash_attention"] == cfg.n_layers * (2 if remat else 1)
        assert bwd["flash_attention_bwd"] == cfg.n_layers


# ---------------------------------------------------------------------------
# mamba2 trains through the ssd_scan kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kernel", [("mamba2-780m", "ssd_scan")])
def test_backward_through_a_card_prefill_equals_the_cpu_run(cuda, ieee_fp32,
                                                            arch, kernel):
    """mamba2-780m's smoke config, fp32: one make_train_step on the card
    (the ssd_scan forward and backward kernels) against the CPU's (plain
    versions, autograd): loss, gradient norm, moments and parameters; one
    forward and one backward launch a layer, and a recompute with remat."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.optim.adamw import tree_leaves

    for remat in (False, True):
        cfg = replace(get_config(arch).smoke(), compute_dtype="float32",
                      remat=remat)
        opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 64)).astype(np.int32))
        batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
        runs = []
        for device in ("cpu", cuda):
            params = _to(init_params(torch.Generator().manual_seed(0), cfg,
                                     device="cpu"), device)
            state = init_opt_state(params, opt)
            SS.reset_launches()
            params, state, m = make_train_step(cfg, opt)(
                params, state, {k: t.to(device) for k, t in batch.items()})
            runs.append((float(m["loss"]), float(m["grad_norm"]),
                         [p.cpu() for p in tree_leaves(params)],
                         [t.cpu() for t in tree_leaves(state["m"])],
                         dict(SS.launches), dict(SS.bwd_launches)))
        (cl, cn, cp, cm, _, _), (gl, gn, gp, gm, fwd, bwd) = runs
        assert abs(gl - cl) < 1e-4 and abs(gn - cn) < 1e-4 * max(1, cn)
        for a, b, ma, mb in zip(gp, cp, gm, cm):
            assert float((ma - mb).abs().max()) <= 1e-4 * float(
                mb.abs().max().clamp_min(1e-30))
            clear = mb.abs() >= 1e-7
            assert float(torch.where(clear, (a - b).abs(), 0.0).max()) < 1e-5
            assert float((a - b).abs().max()) <= 2 * opt.lr + 1e-5
        assert fwd[kernel] == cfg.n_layers * (2 if remat else 1)
        assert bwd[f"{kernel}_bwd"] == cfg.n_layers


# ---------------------------------------------------------------------------
# the serving plane and gossip on the card
# ---------------------------------------------------------------------------

def _serving_flush(device):
    """Two coalesced flushes (puts, then gets with read-repair) through an
    OpScheduler, then a GossipDriver's rounds; returns what each saw and
    every store's roots, with the DVV kernels' launches in the run."""
    from repro_torch.store import GossipDriver, OpScheduler, SimNetwork

    ops.reset_launches()
    c = KVCluster(("n0", "n1", "n2", "n3", "n4"), DVV_MECHANISM,
                  replication=3, read_quorum=2, write_quorum=2, seed=3,
                  network=SimNetwork(seed=3), device=device)
    sch = OpScheduler(c, via="n0", max_batch=256)
    sessions = [sch.session(f"s{i}", read_repair=True) for i in range(8)]
    puts = [s.submit_put({f"k{i}.{j}": (f"v{i}.{j}", None)
                          for j in range(16)})
            for i, s in enumerate(sessions)]
    sch.flush()
    gets = [s.submit_get([f"k{(i + 1) % 8}.{j}" for j in range(16)])
            for i, s in enumerate(sessions)]
    sch.flush()
    c.network.partition({"n0", "n1"}, {"n2", "n3", "n4"})
    c.put("k0.0", "fork", via="n3", quorum=1)
    c.network.queue.clear()
    c.network.heal()
    driver = GossipDriver(c, period=4.0, seed=3)
    driver.run_for(40.0)
    launches = dict(ops.launches)
    seen = ([{k: (a.coordinator, a.replicated_to)
              for k, a in op.result().items()} for op in puts],
            [{k: (r.values, r.context.to_bytes())
              for k, r in op.result().items()} for op in gets],
            sch.stats(), (driver.rounds, driver.wire_bytes()),
            {(n, s): (st.digest_root(), st.value_root())
             for n, node in c.nodes.items()
             for s, st in enumerate(node.shard_stores)})
    return seen, launches


def test_scheduler_flush_and_gossip_round_on_the_card(cuda):
    on_card, launches = _serving_flush(cuda)
    on_cpu, cpu_launches = _serving_flush("cpu")
    assert on_card == on_cpu
    assert on_card[3][0] > 0                       # gossip rounds ran
    assert launches["dvv_sync_mask"] > 0
    assert launches["dvv_read_sweep"] > 0
    assert set(cpu_launches.values()) == {0}
