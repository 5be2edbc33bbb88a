"""The port's LM serving path (dense and Mamba-2) on the CPU against the
JAX package, on the same numpy inputs and the same parameters (the JAX
package's, carried over by ``params_from_numpy``):

  * ``layers``: RMSNorm (both conventions), softcap, GeGLU / SwiGLU, RoPE,
    M-RoPE, cross entropy;
  * ``attention`` against JAX ``attention(use_pallas=True)`` and
    ``(use_pallas=False)``, and ``decode_attention``;
  * ``ssm_forward`` and ``decode_ssm`` on one layer;
  * ``forward`` logits of the smoke configs of gemma2-9b, granite-8b,
    gemma-2b, mamba2-780m and the three MoE configs (qwen3-moe-30b-a3b,
    jamba-1.5-large-398b, grok-1-314b; grok also at its own attention and
    experts, 48 heads over 8 KV heads of 128 and 8 experts top-2; jamba
    also cut to the first 5 layers of its block at its own attention,
    experts and SSD widths; the MoE configs against the default path
    too) against JAX
    ``forward(use_pallas=True)``: <= 1e-4 in fp32, <= 0.05 in bf16 (the
    bound of ``tests/test_kernels.py:224``), and the aux loss (the MoE
    layers' load-balance and z losses, 0 without them);
  * ``count_params`` (total and active) and ``loss_fn``;
  * 8 ``decode_step``s, logits and cache (k/v, or the SSM's conv windows
    and state; jamba's cut both);
  * the two ``BatchScheduler``s side by side (gemma2-9b, mamba2-780m,
    qwen3-moe-30b-a3b and jamba's cut): identical tokens and identical
    session values in the two stores;
  * prefill against token-by-token decode, the CPU twin of
    ``chip_smoke.py``'s ``model_parity`` phase, which sets its tolerance
    (MoE: at 8 tokens, where no token can be dropped; jamba's cut also
    at 4 SSD chunks with a capacity that drops nothing, as
    ``jamba_parity`` (a) runs it).
"""
import importlib
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import layers as JL
from repro.models import lm as JM
from repro_torch import configs as TC
from repro_torch.data import image_positions
from repro_torch.models import layers as TL
from repro_torch.models import lm as TM

# the packages' ``attention`` functions shadow their modules' names
JA = importlib.import_module("repro.models.attention")
TA = importlib.import_module("repro_torch.models.attention")
JS = importlib.import_module("repro.models.ssm")
TS = importlib.import_module("repro_torch.models.ssm")

pytestmark = pytest.mark.torch

DENSE = ("gemma2-9b", "granite-8b", "gemma-2b")
MODELS = DENSE + ("mamba2-780m",)
MOE_MODELS = ("qwen3-moe-30b-a3b", "jamba-1.5-large-398b", "grok-1-314b")
#: hubert-xlarge's smoke config at the config's own head_dim, 80 (the
#: smoke's is 16): the width the flash kernels take for it on the card
HUBERT_D80 = "hubert-xlarge@head_dim80"
#: grok-1-314b's smoke config at the config's own attention and experts,
#: 48 heads over 8 KV heads of 128 and 8 experts top-2 (the smoke's are 4
#: over 2 of 16 and 4): the GQA group of 6 and the routing the card serves
#: at full width
GROK_WIDE = "grok-1-314b@heads48x8d128e8"
#: jamba-1.5-large-398b's smoke config cut as chip_smoke.py cuts the full
#: config, to the first 5 layers of its block (Mamba-2 at 0-3, MoE at 1 and
#: 3, the attention layer at 4), at jamba's own attention (64 heads over 8
#: KV heads of 128), experts (16, top-2) and SSD widths (P 64, N 128)
JAMBA_CUT = "jamba-1.5-large-398b@cut5"
#: the config overrides of a "<arch>@<what>" name; a callable takes the
#: package's own config (the packages' LayerSpecs differ)
CASES = {HUBERT_D80: ("hubert-xlarge", {"head_dim": 80}),
         GROK_WIDE: ("grok-1-314b", {"n_heads": 48, "n_kv_heads": 8,
                                     "head_dim": 128, "moe_experts": 8,
                                     "moe_topk": 2}),
         JAMBA_CUT: ("jamba-1.5-large-398b", {
             "n_layers": 5, "pattern": lambda c: c.pattern[:5],
             "n_heads": 64, "n_kv_heads": 8, "head_dim": 128,
             "moe_experts": 16, "moe_topk": 2, "ssm_headdim": 64,
             "ssm_state": 128})}
MOE_CASES = MOE_MODELS + (GROK_WIDE, JAMBA_CUT)
#: prefill vs token-by-token decode, fp32 logits (final softcap 30 bounds
#: them to +-30): the bound ``chip_smoke.py``'s model_parity phase holds at
#: full width.  At smoke size the two agree far inside it.
PREFILL_DECODE_TOL = 2e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _cfgs(name, compute="float32", **kw):
    """Both packages' smoke configs of an arch or a CASES name."""
    arch, over = CASES.get(name, (name, {}))

    def cfg(package):
        smoke = package.get_config(arch).smoke()
        return replace(smoke, compute_dtype=compute, **{
            k: v(smoke) if callable(v) else v for k, v in over.items()},
            **kw)

    return cfg(JC), cfg(TC)


def _params(jc, tc, seed=0):
    jp = JM.init_params(jax.random.key(seed), jc)
    return jp, TM.params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                    device="cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _layer_case(name, rng):
    x = rng.normal(size=(2, 8, 4, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32) * 0.1
    pos = rng.integers(0, 50, size=(2, 8)).astype(np.int32)
    cases = {
        "rms_norm": lambda L, T: L.rms_norm(T(x), T(w)),
        "rms_norm_zero_centered": lambda L, T: L.rms_norm(
            T(x), T(w), zero_centered=True),
        "softcap": lambda L, T: L.softcap(T(x * 40), 30.0),
        "geglu": lambda L, T: L.geglu(T(x), T(x[::-1].copy())),
        "swiglu": lambda L, T: L.swiglu(T(x), T(x[::-1].copy())),
        "rope_freqs": lambda L, T: L.rope_freqs(16, 10000.0),
        "rope": lambda L, T: L.apply_rope(T(x), T(pos), theta=1e4),
        "mrope": lambda L, T: L.apply_mrope(
            T(x), T(np.stack([pos, pos * 2, pos + 3])), theta=1e6),
        "cross_entropy": lambda L, T: L.cross_entropy(
            T(x.reshape(16, 64)), T(pos.reshape(16))),
        "cross_entropy_masked": lambda L, T: L.cross_entropy(
            T(x.reshape(16, 64)), T(pos.reshape(16)),
            T((pos.reshape(16) % 3 > 0).astype(np.float32))),
    }
    return cases[name]


@pytest.mark.parametrize("name", [
    "rms_norm", "rms_norm_zero_centered", "softcap", "geglu", "swiglu",
    "rope_freqs", "rope", "mrope", "cross_entropy", "cross_entropy_masked"])
def test_layers_match_jax(name):
    case = _layer_case(name, np.random.default_rng(len(name)))
    got = case(TL, _t)
    want = case(JL, jnp.asarray)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_embed_scale_rounds_in_bf16_as_jax():
    """sqrt(3584) = 59.866 rounds to the bf16 grid (step 0.25) first."""
    s = TM._embed({"embed": torch.ones(4, 3584)}, torch.tensor([1]),
                  TC.get_config("gemma2-9b"), torch.bfloat16)
    assert float(s[0, 0]) == float(jnp.asarray(3584 ** 0.5, jnp.bfloat16)) \
        == 59.75


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

SPECS = {
    "gqa_causal": dict(n_heads=4, n_kv_heads=2, head_dim=16),
    "window_softcap": dict(n_heads=4, n_kv_heads=2, head_dim=16,
                           sliding_window=12, attn_softcap=50.0),
    "mqa_qk_norm": dict(n_heads=4, n_kv_heads=1, head_dim=16, qk_norm=True),
    "bidir": dict(n_heads=4, n_kv_heads=4, head_dim=16, causal=False),
    "mrope": dict(n_heads=4, n_kv_heads=2, head_dim=16, mrope=True,
                  rope_theta=1e6),
}


def _attn_inputs(name, seed=0):
    spec_kw = SPECS[name]
    jspec, tspec = JA.AttnSpec(**spec_kw), TA.AttnSpec(**spec_kw)
    jp = JA.init_attn_params(jax.random.key(seed), 32, jspec, jnp.float32)
    tp = {k: _t(v) for k, v in jp.items()}
    x = np.random.default_rng(seed).normal(size=(2, 32, 32)).astype(
        np.float32)
    return jspec, tspec, jp, tp, x


@pytest.mark.parametrize("name", list(SPECS))
@pytest.mark.parametrize("use_pallas", [True, False])
def test_attention_matches_jax(name, use_pallas):
    jspec, tspec, jp, tp, x = _attn_inputs(name)
    want = JA.attention(jp, jnp.asarray(x), jspec, use_pallas=use_pallas)
    got = TA.attention(tp, _t(x), tspec)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", list(SPECS)[:3])
def test_decode_attention_matches_jax(name):
    jspec, tspec, jp, tp, x = _attn_inputs(name, seed=2)
    rng = np.random.default_rng(9)
    cache = {k: rng.normal(size=(2, 24, jspec.n_kv_heads, 16)).astype(
        np.float32) for k in ("k", "v")}
    for pos in (0, 5, 23):
        xs = x[:, pos:pos + 1]
        jout, jcache = JA.decode_attention(
            jp, jnp.asarray(xs), {k: jnp.asarray(v) for k, v in
                                  cache.items()},
            jnp.asarray(pos, jnp.int32), jspec)
        tcache = {k: _t(v) for k, v in cache.items()}
        tout, tcache = TA.decode_attention(tp, _t(xs), tcache, pos, tspec)
        np.testing.assert_allclose(_np(tout), _np(jout), atol=1e-5,
                                   rtol=1e-5)
        for k in cache:
            np.testing.assert_allclose(_np(tcache[k]), _np(jcache[k]),
                                       atol=1e-6)
        cache = {k: np.array(v) for k, v in jcache.items()}


# ---------------------------------------------------------------------------
# the SSM mixer
# ---------------------------------------------------------------------------

def _ssm_inputs(seed=0):
    jc = JC.get_config("mamba2-780m").smoke()
    jspec = JM.ssm_spec(jc)
    tspec = TS.SSMSpec(**vars(jspec))
    jp = JS.init_ssm_params(jax.random.key(seed), jc.d_model, jspec,
                            jnp.float32)
    tp = {k: _t(v) for k, v in jp.items()}
    x = np.random.default_rng(seed).normal(size=(2, 32, jc.d_model)).astype(
        np.float32)
    return jspec, tspec, jp, tp, x


def test_ssm_forward_matches_jax():
    jspec, tspec, jp, tp, x = _ssm_inputs()
    want = JS.ssm_forward(jp, jnp.asarray(x), jspec)
    got = TS.ssm_forward(tp, _t(x), tspec)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


def test_decode_ssm_matches_jax():
    jspec, tspec, jp, tp, x = _ssm_inputs(seed=1)
    rng = np.random.default_rng(2)
    cache = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in
             JS.init_ssm_cache(2, jspec, jnp.float32).items()}
    for pos in (0, 5, 31):
        xs = x[:, pos:pos + 1]
        jout, jcache = JS.decode_ssm(
            jp, jnp.asarray(xs), {k: jnp.asarray(v) for k, v in
                                  cache.items()}, jspec)
        tcache = {k: _t(v) for k, v in cache.items()}
        tout, tcache = TS.decode_ssm(tp, _t(xs), tcache, tspec)
        np.testing.assert_allclose(_np(tout), _np(jout), atol=1e-5,
                                   rtol=1e-5)
        for k in cache:
            np.testing.assert_allclose(_np(tcache[k]), _np(jcache[k]),
                                       atol=1e-5, rtol=1e-5)
        cache = {k: np.array(v) for k, v in jcache.items()}


def test_init_ssm_params_stacks_the_jax_shapes():
    jc = JC.get_config("mamba2-780m").smoke()
    jspec = JM.ssm_spec(jc)
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
            JS.init_ssm_params(jax.random.key(0), jc.d_model, jspec,
                               jnp.bfloat16).items()}
    got = TS.init_ssm_params(torch.Generator().manual_seed(0), jc.d_model,
                             TS.SSMSpec(**vars(jspec)), torch.bfloat16,
                             lead=(3,))
    assert {k: (tuple(v.shape[1:]), str(v.dtype).replace("torch.", ""))
            for k, v in got.items()} == want
    assert all(v.shape[0] == 3 for v in got.values())
    np.testing.assert_allclose(_np(got["A_log"][2]),
                               np.log(np.arange(1, jspec.n_heads + 1)))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MODELS + MOE_MODELS)
def test_count_params_from_shapes_matches_jax(arch):
    """Total and active-only (MoE: top-k of E experts), full size and
    smoke."""
    jc, tc = JC.get_config(arch), TC.get_config(arch)
    for active in (False, True):
        assert TM.count_params(tc, active) == JM.count_params(jc, active)
        assert TM.count_params(tc.smoke(), active) == JM.count_params(
            jc.smoke(), active)
    if arch == "gemma2-9b":
        assert TM.count_params(tc) == 9_241_404_928
    if arch == "mamba2-780m":
        assert TM.count_params(tc) == 780_148_992
    if arch == "qwen3-moe-30b-a3b":
        assert TM.count_params(tc) == 30_532_122_624
        assert TM.count_params(tc, active_only=True) == 3_353_032_704
    if arch not in MOE_MODELS:
        assert TM.count_params(tc, active_only=True) == TM.count_params(tc)


@pytest.mark.parametrize("arch", MODELS + MOE_CASES)
def test_init_params_has_the_jax_shapes_and_dtypes(arch):
    jc, tc = _cfgs(arch)
    want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                        JM.param_specs(jc))
    got = TM.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    flat = jax.tree.map(lambda t: (tuple(t.shape),
                                   str(t.dtype).replace("torch.", "")), got)
    assert flat == want


@pytest.mark.parametrize("arch", MODELS)
@pytest.mark.parametrize("compute,tol", [("float32", 1e-4),
                                         ("bfloat16", 0.05)])
def test_forward_matches_jax_pallas_path(arch, compute, tol):
    jc, tc = _cfgs(arch, compute)
    jp, tp = _params(jc, tc)
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, (2, 32))
    want, _ = JM.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                         replace(jc, use_pallas=True))
    got, aux = TM.forward(tp, {"tokens": _t(toks.astype(np.int32))}, tc)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert np.abs(_np(got) - _np(want)).max() <= tol


def _moe_forward(arch, compute, zero_router=False, use_pallas=True):
    jc, tc = _cfgs(arch, compute)
    jp, tp = _params(jc, tc)
    if zero_router:
        for i, spec in enumerate(jc.pattern):
            if spec.ffn == "moe":
                r = jp["blocks"][f"layer{i}"]["moe"]["router"]
                jp["blocks"][f"layer{i}"]["moe"]["router"] = jnp.zeros_like(r)
                tp["blocks"][f"layer{i}"]["moe"]["router"].zero_()
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, (2, 32))
    want, want_aux = JM.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                                replace(jc, use_pallas=use_pallas))
    got, aux = TM.forward(tp, {"tokens": _t(toks.astype(np.int32))}, tc)
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    return np.abs(_np(got) - _np(want)).max(), float(aux), float(want_aux)


@pytest.mark.parametrize("arch", MOE_CASES)
def test_moe_forward_matches_jax_pallas_path(arch):
    """fp32 logits within 1e-4 and the aux (every MoE layer's load-balance
    and z losses) within 1e-5 of the JAX package's."""
    err, aux, want_aux = _moe_forward(arch, "float32")
    assert err <= 1e-4
    assert abs(aux - want_aux) <= 1e-5 and aux > 0.0


@pytest.mark.parametrize("arch", MOE_CASES)
def test_moe_forward_matches_jax_default_path(arch):
    """The same bounds against the JAX package's default path (jnp
    attention, use_pallas False)."""
    err, aux, want_aux = _moe_forward(arch, "float32", use_pallas=False)
    assert err <= 1e-4
    assert abs(aux - want_aux) <= 1e-5 and aux > 0.0


@pytest.mark.parametrize("arch", MOE_CASES)
def test_moe_forward_bf16_matches_jax_pallas_path(arch):
    """bf16 logits within 0.05 with every router zeroed: each token then
    takes experts 0..K-1 in both packages (``lax.top_k``'s tie order) and
    capacity drops the same tokens, whatever the bf16 activations.  With
    a trained router a token whose K-th and (K+1)-th probabilities lie
    within bf16's rounding of each other takes either expert set, in the
    JAX package too (``test_bf16_routing_flips_are_the_references_own``);
    moe_ffn's own bf16 twins (tests/test_torch_moe.py) route real routers
    on identical inputs."""
    err, aux, want_aux = _moe_forward(arch, "bfloat16", zero_router=True)
    assert err <= 0.05
    assert abs(aux - want_aux) <= 1e-5


def test_bf16_routing_flips_are_the_references_own():
    """On qwen3-moe-30b-a3b's smoke input the JAX package's two bf16 paths
    (use_pallas True and False) differ by more than the bf16 bound, while
    its two fp32 paths agree within 1e-4: the gap is routing that bf16's
    rounding of the router's input turns, not arithmetic."""
    gaps = {}
    for compute in ("float32", "bfloat16"):
        jc, _ = _cfgs("qwen3-moe-30b-a3b", compute)
        jp = JM.init_params(jax.random.key(0), jc)
        toks = jnp.asarray(np.random.default_rng(0).integers(
            0, jc.vocab_size, (2, 32)), jnp.int32)
        pallas, _ = JM.forward(jp, {"tokens": toks},
                               replace(jc, use_pallas=True))
        default, _ = JM.forward(jp, {"tokens": toks}, jc)
        gaps[compute] = np.abs(_np(pallas) - _np(default)).max()
    assert gaps["float32"] <= 1e-4 and gaps["bfloat16"] > 0.05


def test_loss_fn_matches_jax():
    jc, tc = _cfgs("granite-8b")
    jp, tp = _params(jc, tc)
    rng = np.random.default_rng(1)
    toks, labels = (rng.integers(0, jc.vocab_size, (2, 16)).astype(np.int32)
                    for _ in range(2))
    want, _ = JM.loss_fn(jp, {"tokens": jnp.asarray(toks),
                              "labels": jnp.asarray(labels)}, jc)
    got, _ = TM.loss_fn(tp, {"tokens": _t(toks), "labels": _t(labels)}, tc)
    assert abs(float(got) - float(want)) < 1e-4


@pytest.mark.parametrize("arch", MOE_CASES)
def test_moe_loss_fn_matches_jax(arch):
    """Mean CE plus the MoE layers' aux losses, each part held apart."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, tc, seed=1)
    rng = np.random.default_rng(2)
    toks, labels = (rng.integers(0, jc.vocab_size, (2, 16)).astype(np.int32)
                    for _ in range(2))
    want, jparts = JM.loss_fn(jp, {"tokens": jnp.asarray(toks),
                                   "labels": jnp.asarray(labels)}, jc)
    got, tparts = TM.loss_fn(tp, {"tokens": _t(toks), "labels": _t(labels)},
                             tc)
    assert abs(float(got) - float(want)) < 1e-4
    assert abs(float(tparts["aux"]) - float(jparts["aux"])) <= 1e-5
    assert float(tparts["aux"]) > 0.0
    assert abs(float(tparts["ce"]) - float(jparts["ce"])) < 1e-4


@pytest.mark.parametrize("arch", MODELS + MOE_CASES)
def test_decode_steps_match_jax(arch):
    """8 decode steps against the JAX package's ``decode_step``, jitted as
    its ``BatchScheduler`` jits it (one compile; run eagerly, its group
    scan compiles again at every step)."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, tc, seed=3)
    B, max_len = 3, 24
    jcache = JM.init_cache(jc, B, max_len)
    tcache = TM.init_cache(tc, B, max_len, device="cpu")
    rng = np.random.default_rng(4)
    jstep = jax.jit(lambda p, c, t, pos: JM.decode_step(p, c, t, pos, jc))
    for pos in range(8):
        toks = rng.integers(0, jc.vocab_size, (B,)).astype(np.int32)
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks),
                           jnp.asarray(pos, jnp.int32))
        tl, tcache = TM.decode_step(tp, tcache, _t(toks), pos, tc)
        assert np.abs(_np(tl) - _np(jl)).max() < 1e-4
    for layer in jcache:
        assert set(tcache[layer]) == set(jcache[layer])
        for kv in jcache[layer]:
            np.testing.assert_allclose(_np(tcache[layer][kv]),
                                       _np(jcache[layer][kv]), atol=1e-5)


def test_batch_schedulers_serve_identical_tokens_and_sessions():
    _serve_side_by_side("gemma2-9b")


def test_batch_schedulers_serve_identical_mamba_tokens_and_sessions():
    """The same on mamba2-780m's smoke config: the SSM caches of both
    schedulers carry every slot through 32 steps."""
    _serve_side_by_side("mamba2-780m")


def test_batch_schedulers_serve_identical_moe_tokens_and_sessions():
    """The same on qwen3-moe-30b-a3b's smoke config: each decode step
    routes the 4 slots as 4 groups of one token (capacity 8)."""
    _serve_side_by_side("qwen3-moe-30b-a3b")


def test_batch_schedulers_serve_identical_hybrid_tokens_and_sessions():
    """The same on jamba's cut (JAMBA_CUT): each decode step carries the
    attention layer's KV cache and the four Mamba layers' conv windows and
    SSD state for every slot."""
    _serve_side_by_side(JAMBA_CUT)


def _serve_side_by_side(arch):
    import json

    from repro.core import DVV_MECHANISM as JDVV
    from repro.launch import serve as JS
    from repro.store import KVCluster as JCluster, SimNetwork as JNet
    from repro_torch.core import DVV_MECHANISM as TDVV
    from repro_torch.launch import serve as TS
    from repro_torch.store import KVCluster as TCluster, SimNetwork as TNet

    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, tc, seed=5)
    jstore = JCluster(("srv1", "srv2"), JDVV, network=JNet(seed=0))
    tstore = TCluster(("srv1", "srv2"), TDVV, network=TNet(seed=0),
                      device="cpu")
    jsched = JS.BatchScheduler(jc, jp, 4, 64, jstore, "srv1")
    tsched = TS.BatchScheduler(tc, tp, 4, 64, tstore, "srv1")
    jq = [JS.Request(rid=i, prompt_token=i * 7 % 256, max_tokens=16)
          for i in range(8)]
    tq = [TS.Request(rid=i, prompt_token=i * 7 % 256, max_tokens=16)
          for i in range(8)]
    steps = 0
    while jq or any(jsched.slot_req):
        jsched.admit(jq)
        jsched.step()
        steps += 1
    assert TS.serve_requests(tsched, tq) == steps == 32
    for i in range(8):
        jr = jstore.get(f"session/{i}", via="srv1")
        tr = tstore.get(f"session/{i}", via="srv1")
        assert tr.values == jr.values
        assert tr.context.to_bytes() == jr.context.to_bytes()
        assert len(json.loads(tr.values[0])["tokens"]) == 16


@pytest.mark.parametrize("arch", MODELS)
def test_prefill_matches_token_by_token_decode(arch):
    """The CPU twin of chip_smoke.py's model_parity phase: fp32 prefill
    logits at every position against the same tokens fed one by one
    through decode_step, past the sliding window (mamba2: six chunks of
    8, the state crossing chunk boundaries)."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    _, tc = _cfgs(arch)
    tp = TM.init_params(torch.Generator().manual_seed(6), tc, device="cpu")
    S = 48                                   # window 16 at smoke size
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, tc.vocab_size, (1, S)).astype(np.int32))
    pre = make_prefill_step(tc)(tp, {"tokens": toks})[0]
    step = make_decode_step(tc)
    cache = TM.init_cache(tc, 1, S, device="cpu")
    dec = torch.stack([step(tp, cache, toks[:, i], i)[0][0]
                       for i in range(S)])
    err = float((pre - dec).abs().max())
    assert err < PREFILL_DECODE_TOL / 10, err


@pytest.mark.parametrize("arch", MOE_CASES)
def test_moe_prefill_matches_token_by_token_decode(arch):
    """The CPU twin of chip_smoke.py's moe_parity (a): at 8 tokens the
    capacity is 8 (``capacity(S)``'s floor) whether a group holds 8 tokens
    (prefill) or 1 (decode), so no token is dropped on either side and the
    two must agree.  Past 8 a prefill group can drop what decode keeps."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.moe import capacity

    _, tc = _cfgs(arch)
    spec = TM.moe_spec(tc)
    S = 8
    assert capacity(S, spec) == capacity(1, spec) == S
    tp = TM.init_params(torch.Generator().manual_seed(6), tc, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, tc.vocab_size, (1, S)).astype(np.int32))
    pre = make_prefill_step(tc)(tp, {"tokens": toks})[0]
    step = make_decode_step(tc)
    cache = TM.init_cache(tc, 1, S, device="cpu")
    dec = torch.stack([step(tp, cache, toks[:, i], i)[0][0]
                       for i in range(S)])
    err = float((pre - dec).abs().max())
    assert err < PREFILL_DECODE_TOL / 10, err


def test_hybrid_prefill_matches_decode_at_a_raised_capacity():
    """The CPU twin of chip_smoke.py's jamba_parity (a) on jamba's cut:
    fp32 prefill logits of 4 SSD chunks (the state crossing chunk
    boundaries) against token-by-token decode through both caches, at a
    capacity factor that gives capacity(32) >= 32, so that no token is
    dropped on either side (1.25 gives 8)."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.moe import capacity

    S = 32
    _, tc = _cfgs(JAMBA_CUT, capacity_factor=8.0)
    assert S == 4 * tc.ssm_chunk and capacity(S, TM.moe_spec(tc)) >= S
    assert capacity(S, TM.moe_spec(replace(tc, capacity_factor=1.25))) < S
    tp = TM.init_params(torch.Generator().manual_seed(6), tc, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, tc.vocab_size, (1, S)).astype(np.int32))
    pre = make_prefill_step(tc)(tp, {"tokens": toks})[0]
    step = make_decode_step(tc)
    cache = TM.init_cache(tc, 1, S, device="cpu")
    assert {"k", "v"} <= set(cache["layer4"])
    assert {"conv_x", "ssd"} <= set(cache["layer0"])
    dec = torch.stack([step(tp, cache, toks[:, i], i)[0][0]
                       for i in range(S)])
    err = float((pre - dec).abs().max())
    assert err < PREFILL_DECODE_TOL / 10, err


@pytest.mark.parametrize("arch", MOE_MODELS)
def test_serve_main_runs_the_moe_archs(arch, capsys):
    from repro_torch.launch import serve as TS

    assert TS.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--requests", "5", "--tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert "served 5 requests in 6 decode steps" in out
    assert "r4: 3 tokens" in out


def test_serve_main_on_the_cpu(capsys):
    from repro_torch.launch import serve as TS

    assert TS.main(["--store-workload", "--device", "cpu", "--sessions",
                    "1000", "--keys", "50", "--store-steps", "40"]) == 0
    out = capsys.readouterr().out
    assert '"mode": "coalesced"' in out and '"mode": "direct"' in out
    assert "plane ratio direct/coalesced" in out
    assert TS.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu",
                    "--requests", "3", "--tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests in 4 decode steps" in out
    assert "r2: 4 tokens" in out
    assert TS.main(["--arch", "mamba2-780m", "--smoke", "--device", "cpu",
                    "--requests", "5", "--tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert "served 5 requests in 6 decode steps" in out
    assert "r4: 3 tokens" in out


# ---------------------------------------------------------------------------
# qwen3-14b, hubert-xlarge, qwen2-vl-7b, and masks by position
# ---------------------------------------------------------------------------

MORE_MODELS = ("qwen3-14b", "hubert-xlarge", "qwen2-vl-7b")
#: the gradient twins' bounds, tests/test_torch_train.py's: the loss
#: absolutely, each gradient leaf over its largest magnitude (fp32 sums in
#: another order)
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


#: bf16 forward against JAX's Pallas path, max abs logit difference.  The
#: bound of tests/test_kernels.py:224 (0.05) for every arch but
#: qwen3-14b: its smoke logits reach 4.19, where a bf16 step is 0.03125,
#: and the reference's own two bf16 paths (use_pallas True and False)
#: differ by 0.0625 on this input; the port reads 0.0547 against either
#: reference path's 0.0625.  Two bf16 steps at its largest logit.
BF16_LOGIT_TOL = {"qwen3-14b": 0.0625}


def _model_batch(cfg, rng, B, S, dtype=np.float32):
    """The same inputs for both packages: tokens, or embeddings [B,S,d]
    for the embedding-input archs (hubert-xlarge, qwen2-vl-7b)."""
    if cfg.input_mode == "tokens":
        toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        return {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks)}
    emb = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    jdt = jnp.dtype(cfg.compute_dtype)
    return ({"embeddings": jnp.asarray(emb, jdt)},
            {"embeddings": _t(emb).to(getattr(torch, cfg.compute_dtype))})


def _vl_positions(B=2):
    """M-RoPE positions of the ROADMAP's Queue 3 input, for every batch
    row: t = 0..3, then 4 sixteen times (an image's patches), then 5..16;
    h and w lay the sixteen patches out on a 4 x 4 grid (text tokens carry
    t on all three streams)."""
    return image_positions(32, 4, 16, 4, B)


@pytest.mark.parametrize("arch", MORE_MODELS)
def test_more_models_count_params_and_shapes_match_jax(arch):
    jc, tc = JC.get_config(arch), TC.get_config(arch)
    assert TM.count_params(tc) == JM.count_params(jc)
    want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                        JM.param_specs(jc.smoke()))
    got = TM.init_params(torch.Generator().manual_seed(0), tc.smoke(),
                         device="cpu")
    assert jax.tree.map(lambda t: (tuple(t.shape),
                                   str(t.dtype).replace("torch.", "")),
                        got) == want


@pytest.mark.parametrize("arch", MORE_MODELS + (HUBERT_D80,))
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_more_models_forward_matches_jax(arch, compute):
    """fp32: within 1e-4 of both reference paths (Pallas and default);
    bf16: within BF16_LOGIT_TOL of the Pallas path."""
    jc, tc = _cfgs(arch, compute)
    jp, tp = _params(jc, tc)
    jb, tb = _model_batch(jc, np.random.default_rng(0), 2, 32)
    got, _ = TM.forward(tp, tb, tc)
    paths = (True, False) if compute == "float32" else (True,)
    tol = 1e-4 if compute == "float32" else BF16_LOGIT_TOL.get(arch, 0.05)
    for use_pallas in paths:
        want, _ = JM.forward(jp, jb, replace(jc, use_pallas=use_pallas))
        err = np.abs(_np(got) - _np(want)).max()
        assert err <= tol, (use_pallas, err)


@pytest.mark.parametrize("name", ["hubert-xlarge", HUBERT_D80])
def test_more_models_loss_and_gradients_match_jax(name):
    """fp32 loss_fn on frame embeddings and labels in [0, vocab_size), and
    its gradient w.r.t. every parameter leaf (through the flash plain
    version's autograd), against jax.value_and_grad of the JAX package's
    loss_fn on the same parameters."""
    from repro_torch.optim.adamw import tree_leaves, tree_unflatten

    jc, tc = _cfgs(name)
    jp, tp = _params(jc, tc, seed=5)
    rng = np.random.default_rng(6)
    jb, tb = _model_batch(jc, rng, 2, 32)
    labels = rng.integers(0, jc.vocab_size, (2, 32)).astype(np.int32)
    jb["labels"], tb["labels"] = jnp.asarray(labels), _t(labels)
    (want, _), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jb, jc), has_aux=True)(jp)
    leaves = [t.detach().requires_grad_() for t in tree_leaves(tp)]
    got, _ = TM.loss_fn(tree_unflatten(tp, leaves), tb, tc)
    tgrads = torch.autograd.grad(got, leaves)
    assert abs(float(got.detach()) - float(want)) <= LOSS_TOL
    jleaves = jax.tree.leaves(jgrads)
    assert len(tgrads) == len(jleaves)
    for g, w in zip(tgrads, jleaves):
        assert tuple(g.shape) == w.shape
        err = np.abs(_np(g) - _np(w)).max() / max(np.abs(_np(w)).max(),
                                                  1e-30)
        assert err <= GRAD_TOL


def test_qwen3_bf16_bound_is_the_reference_paths_own_gap():
    """BF16_LOGIT_TOL's qwen3-14b entry: the JAX package's two bf16 paths
    (use_pallas True and False) differ on the same input by at least the
    bound, which is two bf16 steps at the largest logit."""
    jc, _ = _cfgs("qwen3-14b", "bfloat16")
    jp = JM.init_params(jax.random.key(0), jc)
    jb, _ = _model_batch(jc, np.random.default_rng(0), 2, 32)
    pallas, _ = JM.forward(jp, jb, replace(jc, use_pallas=True))
    default, _ = JM.forward(jp, jb, jc)
    gap = np.abs(_np(pallas) - _np(default)).max()
    top = np.abs(_np(pallas)).max()
    step = 2.0 ** (np.floor(np.log2(top)) - 7)          # bf16: 8 bits
    assert gap >= BF16_LOGIT_TOL["qwen3-14b"] == 2 * step


@pytest.mark.parametrize("arch", MORE_MODELS)
def test_more_models_decode_steps_match_jax(arch):
    """8 decode steps in fp32, logits and caches.  hubert-xlarge is an
    encoder that serving never decodes; its decode step is still the JAX
    package's function, and held to it."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, tc, seed=3)
    B, max_len = 3, 24
    jcache = JM.init_cache(jc, B, max_len)
    tcache = TM.init_cache(tc, B, max_len, device="cpu")
    rng = np.random.default_rng(4)
    for pos in range(8):
        jb, tb = _model_batch(jc, rng, B, 1)
        jin = jb.get("tokens", jb.get("embeddings"))[:, 0]
        tin = tb.get("tokens", tb.get("embeddings"))[:, 0]
        jl, jcache = JM.decode_step(jp, jcache, jin,
                                    jnp.asarray(pos, jnp.int32), jc)
        tl, tcache = TM.decode_step(tp, tcache, tin, pos, tc)
        assert np.abs(_np(tl) - _np(jl)).max() < 1e-4
    for layer in jcache:
        for kv in jcache[layer]:
            np.testing.assert_allclose(_np(tcache[layer][kv]),
                                       _np(jcache[layer][kv]), atol=1e-5)


def test_mrope_positions_logits_match_jax_default_path():
    """The ROADMAP's Queue 3 input: qwen2-vl-7b smoke, fp32, parameters
    from jax.random.key(0), embeddings [2, 32] from default_rng(0), image
    positions.  The reference's default path masks by the temporal row;
    its Pallas path masks by index and parts from it by about 2.35."""
    jc, tc = _cfgs("qwen2-vl-7b")
    jp, tp = _params(jc, tc)
    jb, tb = _model_batch(jc, np.random.default_rng(0), 2, 32)
    pos = _vl_positions()
    got, _ = TM.forward(tp, dict(tb, positions=_t(pos)), tc)
    want, _ = JM.forward(jp, dict(jb, positions=jnp.asarray(pos)), jc)
    pallas, _ = JM.forward(jp, dict(jb, positions=jnp.asarray(pos)),
                           replace(jc, use_pallas=True))
    assert np.abs(_np(got) - _np(want)).max() <= 1e-4
    assert np.abs(_np(got) - _np(pallas)).max() > 1.0   # positions count


def test_mrope_positions_attention_layer_matches_jax_default_path():
    jspec, tspec, jp, tp, x = _attn_inputs("mrope")
    pos = _vl_positions()
    want = JA.attention(jp, jnp.asarray(x), jspec,
                        positions=jnp.asarray(pos))
    got = TA.attention(tp, _t(x), tspec, positions=_t(pos))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    # default positions: the index path, within 1e-5 of the Pallas path
    want = JA.attention(jp, jnp.asarray(x), jspec, use_pallas=True)
    got = TA.attention(tp, _t(x), tspec)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["gqa_causal", "window_softcap", "bidir"])
def test_explicit_positions_match_jax_default_path(name):
    """[B, S] positions with repeats, gaps and a step back, on the
    non-M-RoPE specs: masks by batch row 0, as the reference does."""
    jspec, tspec, jp, tp, x = _attn_inputs(name, seed=1)
    row = np.array([0, 1, 2, 2, 2, 5, 6, 4, 9, 10, 10, 11, 14, 13, 15, 20,
                    21, 22, 22, 23, 30, 31, 29, 32, 33, 34, 40, 41, 41, 42,
                    43, 44], np.int32)
    pos = np.stack([row, row + 3])
    want = JA.attention(jp, jnp.asarray(x), jspec,
                        positions=jnp.asarray(pos))
    got = TA.attention(tp, _t(x), tspec, positions=_t(pos))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
