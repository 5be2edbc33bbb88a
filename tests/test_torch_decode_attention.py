"""Decode attention's front end (``repro_torch.kernels.decode_attention``)
on the CPU, where it takes the plain version:

  * the plain version is the full-cache masked math that
    ``models.attention.decode_attention`` ran before the kernel, bit for
    bit, at position 0, at a sliding window's edge and at the cache's last
    slot, with and without softcap and window, in fp32 and bf16;
  * attending over the live keys alone (``ref.live_keys``, what the CUDA
    kernel reads) gives the same result, in float64;
  * the split rule (``decode_attention.splits``) cuts the live keys into
    non-empty chunks that cover them, more of them where B * KV blocks
    alone leave the SMs idle;
  * under ``tracing.enable()`` each call adds B * (pos - lo + 1) to
    ``decode_attention.keys_read`` and B * Smax to
    ``decode_attention.keys_cached``, a decode step once per attention
    layer, and ``serve --trace`` prints both; tracing off adds nothing.

The CUDA kernel against this plain version: ``tests/test_torch_cuda.py``.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import decode_attend
from repro_torch.kernels.decode_attention import decode_attention as DK
from repro_torch.kernels.decode_attention.ref import live_keys
from repro_torch.models import decode_step, init_cache, init_params
from repro_torch.models.attention import NEG_INF
from repro_torch.models.layers import softcap as apply_softcap
from repro_torch.models.lm import attn_spec
from repro_torch.runtime import tracing

pytestmark = pytest.mark.torch

SMAX = 48
WINDOW = 16


def _full_cache_math(qg, k, v, pos, window, cap, scale):
    """The attention of ``decode_attention`` before the kernel, line for
    line: scores over every slot, masked after the product."""
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg,
                          k.to(qg.dtype)).float() * scale
    if cap:
        scores = apply_softcap(scores, cap)
    kpos = torch.arange(k.shape[1], dtype=torch.int32)
    ok = kpos <= pos
    if window:
        ok &= kpos > pos - window
    scores = torch.where(ok, scores, torch.tensor(NEG_INF,
                                                  dtype=torch.float32))
    probs = torch.softmax(scores, dim=-1).to(qg.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v.to(qg.dtype))


def _inputs(B=3, KV=2, G=3, D=16, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32) * 2)
               .to(dtype) for shape in ((B, 1, KV, G, D),
                                        (B, SMAX, KV, D), (B, SMAX, KV, D)))
    return q, k, v


POSITIONS = {"first": lambda w: 0, "window_edge": lambda w: w or SMAX // 2,
             "before_edge": lambda w: (w or SMAX // 2) - 1,
             "last": lambda w: SMAX - 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, WINDOW])
@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("at", list(POSITIONS))
def test_plain_version_is_the_full_cache_masked_math(dtype, window, cap, at):
    q, k, v = _inputs(dtype=dtype, seed=len(at) + window)
    pos = POSITIONS[at](window)
    got = decode_attend(q, k, v, pos, window=window, softcap=cap)
    want = _full_cache_math(q, k, v, pos, window, cap, 16 ** -0.5)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("window", [0, WINDOW])
@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("pos", [0, WINDOW - 1, WINDOW, 31, SMAX - 1])
def test_live_keys_alone_give_the_same_attention(window, cap, pos):
    q, k, v = _inputs(seed=pos)
    scale = 0.3
    got = decode_attend(q, k, v, pos, window=window, softcap=cap,
                        scale=scale)
    keys = live_keys(pos, window)
    assert keys.stop == pos + 1 and len(keys) == \
        (min(pos + 1, window) if window else pos + 1)
    q64, k64, v64 = (t.double() for t in (q, k, v))
    live_k, live_v = k64[:, keys.start:keys.stop], v64[:, keys.start:keys.stop]
    s = torch.einsum("bqkgh,bskh->bkgqs", q64, live_k) * scale
    if cap:
        s = cap * torch.tanh(s / cap)
    want = torch.einsum("bkgqs,bskh->bqkgh", torch.softmax(s, -1), live_v)
    # fp32 sums of a few dozen terms against float64: a few ulps
    np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,KV,L", [
    (32, 8, 1), (32, 8, 600), (32, 8, 8192), (1, 8, 524288), (1, 1, 4096),
    (4, 8, 255), (2, 2, 100000), (128, 8, 8192)])
def test_splits_cover_the_live_keys(B, KV, L):
    sms = 132
    nsplit, chunk = DK.splits(B, KV, L, sms)
    assert nsplit >= 1 and chunk >= 1
    assert (nsplit - 1) * chunk < L <= nsplit * chunk       # none empty
    assert nsplit == 1 or chunk >= DK.MIN_SPLIT_KEYS
    if B * KV >= DK.BLOCKS_PER_SM * sms or L < 2 * DK.MIN_SPLIT_KEYS:
        assert nsplit == 1
    else:
        assert nsplit > 1
    assert B * KV * nsplit <= max(B * KV, DK.BLOCKS_PER_SM * sms + B * KV)


def test_kernel_entry_refuses_a_cpu_tensor():
    q, k, v = _inputs()
    with pytest.raises(ValueError, match="CUDA kernel"):
        DK.attend(q, k, v, 3)


@pytest.fixture
def traced():
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.drain()


def _counters():
    return {name: n for name, n in tracing.snapshot()["counters"].items()
            if name.startswith("decode_attention.")}


def test_counters_count_live_and_cached_keys(traced):
    q, k, v = _inputs(B=3)
    calls = [(0, 0), (10, 0), (SMAX - 1, 0), (5, WINDOW), (30, WINDOW),
             (SMAX - 1, WINDOW)]
    for pos, window in calls:
        decode_attend(q, k, v, pos, window=window)
    read = sum(3 * (pos - max(0, pos - window + 1 if window else 0) + 1)
               for pos, window in calls)
    assert read == 3 * (1 + 11 + 48 + 6 + 16 + 16)
    want = {"decode_attention.keys_read": read,
            "decode_attention.keys_cached": 3 * SMAX * len(calls)}
    assert _counters() == want
    tracing.disable()
    decode_attend(q, k, v, 20)
    assert _counters() == want


def test_counters_stay_empty_while_tracing_is_off():
    tracing.disable()
    tracing.enable()
    tracing.disable()
    q, k, v = _inputs()
    decode_attend(q, k, v, 7)
    assert _counters() == {}
    tracing.drain()


def test_decode_step_counts_each_attention_layer(traced):
    cfg = get_config("gemma2-9b").smoke()      # global and windowed layers
    params = init_params(torch.Generator().manual_seed(0), cfg,
                         device="cpu")
    B, max_len = 2, 40
    cache = init_cache(cfg, B, max_len, device="cpu")
    windows = [attn_spec(cfg, s).sliding_window for s in cfg.pattern
               if s.mixer.startswith("attn")] * cfg.n_groups
    tokens = torch.tensor([3, 5])
    read = 0
    for pos in (0, 1, 20, 39):
        _, cache = decode_step(params, cache, tokens, pos, cfg)
        read += sum(B * len(live_keys(pos, w)) for w in windows)
    assert any(windows) and not all(windows)
    assert _counters() == {
        "decode_attention.keys_read": read,
        "decode_attention.keys_cached": 4 * len(windows) * B * max_len}


def test_serve_trace_prints_the_counters(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", "grok-1-314b", "--smoke", "--device",
                       "cpu", "--requests", "3", "--tokens", "2",
                       "--trace"]) == 0
    tracing.drain()
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("{"))
    counters = json.loads(line)["counters"]
    read = counters["decode_attention.keys_read"]
    cached = counters["decode_attention.keys_cached"]
    assert 0 < read < cached
    assert json.loads(line)["launches"]["decode_attention.launches"] == {
        "decode_attention": 0, "decode_attention_combine": 0}
