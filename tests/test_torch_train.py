"""Training through the port on the CPU against the JAX package, on the
same numpy inputs and the same parameters (the JAX package's, carried over
by ``params_from_numpy``):

  * the flash-attention backward's plain version
    (``ref.flash_attention_bwd_ref``, what the CUDA backward kernel is held
    to on the card) against ``jax.vjp`` of the JAX package's
    ``_attend_naive`` over the option grid (causal, bidirectional, window,
    softcap, GQA and MQA, masks by position), fp32: within 1e-5 of each
    gradient's largest magnitude; the statistics the bf16 forward keeps
    for the backward (``ref.flash_attention_stats_ref``: each row's
    logsumexp and the fp32 output; ``ref.delta_ref``) against
    ``jax.nn.logsumexp`` of that path's masked scores, its output and
    rowsum(dO o O); and a float64 emulation of the bf16 kernels' numerics
    showing that delta taken from the forward's fp32 output keeps dq's
    worst row within 0.08 of the plain version's;
  * ``loss_fn`` and every gradient leaf against ``jax.value_and_grad`` of
    the JAX package's ``loss_fn`` on the smoke configs of gemma-2b,
    gemma2-9b, qwen3-14b and mamba2-780m, fp32: the loss within 1e-5, each
    leaf within 1e-4 of its largest magnitude (the sums of a backward pass
    run in another order in each framework; the largest reading is 1.4e-5);
  * one ``make_train_step`` against the JAX package's: moments and
    metrics within the same bounds, parameters within 1e-6 wherever the
    gradient is far above Adam's eps (its first step moves an entry by lr
    times the gradient's sign) and within 2 lr elsewhere;
  * ``forward`` with ``remat`` on (both policies) and off: the same loss
    and gradients, bit for bit (the same operations recomputed);
  * checkpoints: the flattened state's names, shapes and dtypes are the
    JAX package's; a JAX ``Trainer``'s checkpoint restores in the port's
    with an equal ``state_fingerprint``, and the reverse; the port's
    crash/restart resumes bit for bit;
  * the control plane around training: ``SimCluster`` (the scenarios of
    tests/test_simcluster.py) gives the JAX package's events, steps and
    meshes, and the work-stealing schedules of
    tests/test_straggler_training.py give its ledger.
"""
import importlib
import random
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.ckpt import CheckpointManager as JCkpt
from repro.core import DVV_MECHANISM as J_DVV
from repro.data import PipelineConfig as JPipe
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import ModelConfig as JModelConfig
from repro.models import lm as JM
from repro.optim import AdamWConfig as JAdamW
from repro.optim import init_opt_state as j_init_opt_state
from repro.runtime import train_loop as JT
from repro.runtime.simcluster import SimCluster as JSim
from repro.store import KVCluster as JKV
from repro.store import SimNetwork as JNet
from repro_torch import configs as TC
from repro_torch.ckpt import CheckpointManager as TCkpt
from repro_torch.core import DVV_MECHANISM as T_DVV
from repro_torch.data import PipelineConfig as TPipe
from repro_torch.kernels.flash_attention.ref import (
    delta_ref, flash_attention_bwd_ref, flash_attention_ref,
    flash_attention_stats_ref, grad_row_err,
)
from repro_torch.launch.steps import make_train_step as t_make_train_step
from repro_torch.models import ModelConfig as TModelConfig
from repro_torch.models import lm as TM
from repro_torch.optim import AdamWConfig as TAdamW
from repro_torch.optim import init_opt_state as t_init_opt_state
from repro_torch.optim.adamw import tree_leaves, tree_unflatten
from repro_torch.runtime import train_loop as TT
from repro_torch.runtime.simcluster import SimCluster as TSim
from repro_torch.store import KVCluster as TKV
from repro_torch.store import SimNetwork as TNet

JA = importlib.import_module("repro.models.attention")
JL = importlib.import_module("repro.models.layers")

pytestmark = pytest.mark.torch

GRAD_TOL = 1e-4       # each gradient leaf, of its largest magnitude
LOSS_TOL = 1e-5
ARCHS = ("gemma-2b", "gemma2-9b", "qwen3-14b", "mamba2-780m")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _rel(got, want):
    """max |got - want| over max |want|."""
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# the flash-attention backward's plain version
# ---------------------------------------------------------------------------

BWD_MODES = {
    "causal": dict(causal=True, window=0, softcap=0.0),
    "bidir": dict(causal=False, window=0, softcap=0.0),
    "window": dict(causal=True, window=24, softcap=0.0),
    "softcap": dict(causal=True, window=0, softcap=30.0),
    "window_softcap": dict(causal=True, window=24, softcap=20.0),
}


@pytest.mark.parametrize("mode", list(BWD_MODES))
@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (4, 1)])
@pytest.mark.parametrize("positions", [False, True])
def test_flash_backward_plain_version_matches_jax_grad(mode, heads,
                                                       positions):
    H, KV = heads
    B, S, D = 2, 80, 16
    kw = BWD_MODES[mode]
    rng = np.random.default_rng([H, KV, len(mode), positions])
    q, dout = (rng.normal(size=(B, S, H, D)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.normal(size=(B, S, KV, D)).astype(np.float32)
            for _ in range(2))
    pos = (rng.permutation(S) // 3 if positions else np.arange(S)).astype(
        np.int32)
    spec = JA.AttnSpec(n_heads=H, n_kv_heads=KV, head_dim=D,
                       attn_softcap=kw["softcap"],
                       sliding_window=kw["window"], causal=kw["causal"])

    def attend(q, k, v):
        out = JA._attend_naive(q.reshape(B, S, KV, H // KV, D), k, v,
                               jnp.asarray(pos), jnp.asarray(pos), spec)
        return out.reshape(B, S, H, D)

    _, vjp = jax.vjp(attend, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (_t(a) for a in (q, k, v))
    tkw = dict(kw, positions=_t(pos) if positions else None)
    out = flash_attention_ref(tq, tk, tv, **tkw)
    got = flash_attention_bwd_ref(tq, tk, tv, out, _t(dout), **tkw)
    for g, w, t in zip(got, want, (tq, tk, tv)):
        assert g.shape == t.shape and g.dtype == t.dtype
        assert _rel(g, w) <= 1e-5


@pytest.mark.parametrize("mode", list(BWD_MODES))
@pytest.mark.parametrize("positions", [False, True])
def test_flash_statistics_plain_versions_match_jax(mode, positions):
    """The row logsumexp of ``flash_attention_stats_ref`` against
    ``jax.nn.logsumexp`` of the JAX package's masked scores (its default
    path's products, softcap and ``_mask_bias``), within 1e-5 of max(1,
    |lse|); its fp32 output against that path's output and ``delta_ref``
    against rowsum(dO o O) taken in JAX, within 1e-5 of the largest
    magnitude (fp32 sums in another order)."""
    H, KV = 4, 2
    B, S, D = 2, 80, 16
    kw = BWD_MODES[mode]
    rng = np.random.default_rng([H, KV, len(mode), positions, 1])
    q, dout = (rng.normal(size=(B, S, H, D)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.normal(size=(B, S, KV, D)).astype(np.float32)
            for _ in range(2))
    pos = (rng.permutation(S) // 3 if positions else np.arange(S)).astype(
        np.int32)
    spec = JA.AttnSpec(n_heads=H, n_kv_heads=KV, head_dim=D,
                       attn_softcap=kw["softcap"],
                       sliding_window=kw["window"], causal=kw["causal"])
    jpos = jnp.asarray(pos)
    qg = jnp.asarray(q).reshape(B, S, KV, H // KV, D)
    scores = jnp.einsum("bqkgh,bskh->bkgqs", qg, jnp.asarray(k)).astype(
        jnp.float32) * D ** -0.5
    scores = JL.softcap(scores, kw["softcap"]) + \
        JA._mask_bias(jpos, jpos, spec)[None, None, None]
    want_lse = jax.nn.logsumexp(scores, axis=-1).reshape(B, H, S)
    want_out = JA._attend_naive(qg, jnp.asarray(k), jnp.asarray(v), jpos,
                                jpos, spec).reshape(B, S, H, D)
    want_delta = jnp.sum(jnp.asarray(dout) * want_out, axis=-1).transpose(
        0, 2, 1)
    tkw = dict(kw, positions=_t(pos) if positions else None)
    out32, lse = flash_attention_stats_ref(*(_t(a) for a in (q, k, v)),
                                           **tkw)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    assert out32.shape == (B, S, H, D) and out32.dtype == torch.float32
    assert float(np.max(np.abs(_np(lse) - _np(want_lse)) /
                        np.maximum(1.0, np.abs(_np(want_lse))))) <= 1e-5
    assert _rel(out32, want_out) <= 1e-5
    assert _rel(delta_ref(out32, _t(dout)), want_delta) <= 1e-5


LOG2E = 1.0 / np.log(2.0)
#: dq's worst row (``grad_row_err``) against the plain version's bf16
#: gradient that the bf16 backward must stay under when it takes delta from
#: the forward's fp32 output (0.034 at global_capped's inputs below; from
#: the bf16 output 0.110); the card gate is 2^-2.
DELTA_EMULATION_TOL = 0.08


def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def _emulated_dq(q, k, v, dout, cap, bf16_output=False):
    """dq of the bf16 kernels in float64 (causal): the forward's online
    softmax over 80-key tiles with p (fp32) rounded to bf16 against the
    running maximum before p.v, its fp32 output O and logsumexp; then
    delta = rowsum(dO o O) (O rounded to bf16 first if ``bf16_output``),
    P = 2^(s - lse), dS = P (dP - delta) (1 - tanh^2) rounded to bf16 as
    the dQ product's operand, dq = scale dS K."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    scale = D ** -0.5
    qf = q.double().reshape(B, S, KV, H // KV, D).permute(0, 2, 3, 1, 4)
    kf = k.double().permute(0, 2, 1, 3)[:, :, None]
    vf = v.double().permute(0, 2, 1, 3)[:, :, None]
    dof = dout.double().reshape(B, S, KV, H // KV, D).permute(0, 2, 3, 1, 4)
    dot = qf @ kf.transpose(-1, -2)
    if cap:
        th = torch.tanh(dot * scale / cap)
        s2, fac = cap * LOG2E * th, 1 - th * th
    else:
        s2, fac = dot * scale * LOG2E, torch.ones_like(dot)
    ok = torch.ones(S, S, dtype=torch.bool).tril()
    s2 = torch.where(ok, s2, torch.tensor(-1e38, dtype=torch.float64))
    m = torch.full(s2.shape[:-1] + (1,), -1e38, dtype=torch.float64)
    l = torch.zeros_like(m)
    acc = torch.zeros(qf.shape, dtype=torch.float64)
    for k0 in range(0, S, 80):
        tile = s2[..., k0:k0 + 80]
        mn = torch.maximum(m, tile.amax(-1, keepdim=True))
        c = torch.exp2(m - mn)
        p = torch.exp2(tile - mn).float().double()
        l = l * c + p.sum(-1, keepdim=True)
        acc = acc * c + _bf16(p) @ vf[..., k0:k0 + 80, :]
        m = mn
    out = (acc / l).float().double()
    if bf16_output:
        out = _bf16(out)
    delta = (dof * out).sum(-1, keepdim=True)
    P = torch.where(ok, torch.exp2(s2 - m - torch.log2(l)),
                    torch.zeros((), dtype=torch.float64))
    dS = _bf16(P * (dof @ vf.transpose(-1, -2) - delta) * fac)
    return (scale * (dS @ kf)).permute(0, 3, 1, 2, 4).reshape(B, S, H, D)


@pytest.mark.parametrize("case", ["global_capped", "gemma_2b"])
def test_delta_from_the_fp32_output_keeps_dq_near_the_plain_version(case):
    """The bf16 backward's delta taken from the forward's fp32 output, on
    chip_smoke.py's global_capped row (q 30 times N(0, 1), softcap 50:
    rows where dS cancels) and gemma-2b's (MQA, no cap), scaled down to
    512 positions, head_dim 256: dq's worst row within
    DELTA_EMULATION_TOL of the plain version's bf16 gradient; with the
    softcap, delta from the bf16 output reads above that bound."""
    H, KV, q_scale, cap = (4, 2, 30.0, 50.0) if case == "global_capped" \
        else (4, 1, 1.0, 0.0)
    S, D = 512, 256
    rng = np.random.default_rng([0, S, H])
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(
        (1, S, h, D), dtype=np.float32) * x).to(torch.bfloat16)
        for h, x in ((H, q_scale), (KV, 1.0), (KV, 1.0), (H, 1.0)))
    plain = flash_attention_bwd_ref(q, k, v, None, dout, causal=True,
                                    softcap=cap)[0]
    assert grad_row_err(_emulated_dq(q, k, v, dout, cap), plain) \
        < DELTA_EMULATION_TOL
    if cap:
        assert grad_row_err(_emulated_dq(q, k, v, dout, cap,
                                         bf16_output=True), plain) \
            > DELTA_EMULATION_TOL


# ---------------------------------------------------------------------------
# loss, gradients, one train step, remat
# ---------------------------------------------------------------------------

def _cfgs(arch, **kw):
    jc = replace(JC.get_config(arch).smoke(), compute_dtype="float32", **kw)
    tc = replace(TC.get_config(arch).smoke(), compute_dtype="float32", **kw)
    return jc, tc


def _params(jc, tc, seed=0):
    jp = JM.init_params(jax.random.key(seed), jc)
    return jp, TM.params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                    device="cpu")


def _batch(vocab, seed=1, shape=(2, 32)):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, shape).astype(np.int32)
            for k in ("tokens", "labels")}


def _grads(params, batch, cfg):
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, _ = TM.loss_fn(tree_unflatten(params, leaves), batch, cfg)
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_jax(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, tc)
    batch = _batch(jc.vocab_size)
    (want, _), jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, {k: jnp.asarray(v) for k, v in
                                 batch.items()}, jc), has_aux=True)(jp)
    got, tgrads = _grads(tp, {k: _t(v) for k, v in batch.items()}, tc)
    assert abs(float(got) - float(want)) <= LOSS_TOL
    jleaves = jax.tree.leaves(jgrads)
    assert len(tgrads) == len(jleaves)
    for g, w in zip(tgrads, jleaves):
        assert tuple(g.shape) == w.shape
        assert _rel(g, w) <= GRAD_TOL


def test_train_step_matches_jax():
    jc, tc = _cfgs("gemma-2b")
    jp, tp = _params(jc, tc, seed=3)
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    jo_cfg, to_cfg = JAdamW(**cfg), TAdamW(**cfg)
    jo, to = j_init_opt_state(jp, jo_cfg), t_init_opt_state(tp, to_cfg)
    batch = _batch(jc.vocab_size, seed=4)
    jp, jo, jm = j_make_train_step(jc, jo_cfg)(
        jp, jo, {k: jnp.asarray(v) for k, v in batch.items()})
    tp, to, tm = t_make_train_step(tc, to_cfg)(
        tp, to, {k: _t(v) for k, v in batch.items()})
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        assert abs(float(tm[key]) - float(jm[key])) <= \
            LOSS_TOL * max(1.0, abs(float(jm[key])))
    for tree_t, tree_j in ((to["m"], jo["m"]), (to["v"], jo["v"])):
        for g, w in zip(tree_leaves(tree_t), jax.tree.leaves(tree_j)):
            assert _rel(g, w) <= GRAD_TOL
    # Adam's first step moves each entry by lr * g / (|g| + eps): by lr
    # with g's sign wherever |g| is far above eps and the gradients' error,
    # by up to 2 lr (opposite signs) where it is not.
    for g, w, m in zip(tree_leaves(tp), jax.tree.leaves(jp),
                       jax.tree.leaves(jo["m"])):
        diff = np.abs(_np(g) - _np(w))
        clear = np.abs(_np(m)) >= 1e-7            # |g| >= 1e-6
        assert (diff[clear] <= 1e-6).all()
        assert (diff <= 2 * cfg["lr"] + 1e-6).all()
    assert int(to["step"]) == int(jo["step"]) == 1
    assert all(not p.requires_grad for p in tree_leaves(tp))


@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-780m"])
@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_gives_the_same_loss_and_gradients(arch, policy):
    _, tc = _cfgs(arch)
    params = TM.init_params(torch.Generator().manual_seed(0), tc,
                            device="cpu")
    batch = {k: _t(v) for k, v in _batch(tc.vocab_size).items()}
    base_loss, base = _grads(params, batch, tc)
    loss, grads = _grads(params, batch, replace(tc, remat=True,
                                                remat_policy=policy))
    assert torch.equal(loss, base_loss)
    assert all(torch.equal(g, w) for g, w in zip(grads, base))


# ---------------------------------------------------------------------------
# checkpoints across the packages, bitwise resume
# ---------------------------------------------------------------------------

STORE = ("s1", "s2", "s3")
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=128, remat=False)


def _trainer(pkg, root, store=None, node="s1", total=6, ckpt_every=3,
             **opt):
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=total, **opt)
    pipe = dict(vocab_size=128, seq_len=16, global_batch=4, seed=1)
    tcfg = dict(total_steps=total, ckpt_every=ckpt_every, log_every=1)
    if pkg == "jax":
        store = store or JKV(STORE, J_DVV, network=JNet(seed=0))
        return JT.Trainer(JModelConfig(**TINY), JAdamW(**opt), JPipe(**pipe),
                          JT.TrainerConfig(**tcfg),
                          JCkpt(store, str(root), "run0", node)), store
    store = store or TKV(STORE, T_DVV, network=TNet(seed=0), device="cpu")
    return TT.Trainer(TModelConfig(**TINY), TAdamW(**opt), TPipe(**pipe),
                      TT.TrainerConfig(**tcfg),
                      TCkpt(store, str(root), "run0", node),
                      device="cpu"), store


def test_flattened_state_has_the_jax_names_shapes_and_dtypes(tmp_path):
    for master in (False, True):
        jt, _ = _trainer("jax", tmp_path / "j", master_weights=master)
        tt, _ = _trainer("torch", tmp_path / "t", master_weights=master)
        jt.init_fresh()
        tt.init_fresh()
        want = JT._flatten_state(jt.params, jt.opt_state)
        got = TT._flatten_state(tt.params, tt.opt_state)
        assert list(got) == list(want)
        assert "p/blocks/layer0/attn/wq" in got and "o/step" in got
        for name in want:
            assert got[name].shape == want[name].shape
            assert got[name].dtype == want[name].dtype


def _carry_manifest(src_store, dst_store):
    """Copy the run's manifest value from one package's store into the
    other's, as a deployment moving the control plane would."""
    key = "ckpt/run0/manifest"
    (value,) = src_store.get(key, via="s1").values
    dst_store.put(key, value, via="s1", client_id="mover")


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoint_restores_across_the_packages(tmp_path, direction):
    src_pkg, dst_pkg = direction.split("_to_")
    src, src_store = _trainer(src_pkg, tmp_path)
    src.init_fresh()
    src.run(steps=3)                       # checkpoints at step 3
    dst, dst_store = _trainer(dst_pkg, tmp_path)
    _carry_manifest(src_store, dst_store)
    assert dst.try_restore()
    assert dst.step == 3 and dst.pipeline.state() == src.pipeline.state()
    assert dst.state_fingerprint() == src.state_fingerprint()
    want = (JT._flatten_state if src_pkg == "jax" else TT._flatten_state)(
        src.params, src.opt_state)
    got = (JT._flatten_state if dst_pkg == "jax" else TT._flatten_state)(
        dst.params, dst.opt_state)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


def test_crash_restart_bitwise_resume(tmp_path):
    """tests/test_fault_tolerance.py's crash/restart, on the port."""
    ref, _ = _trainer("torch", tmp_path / "ref", total=9)
    ref.init_fresh()
    ref.run()
    t1, store = _trainer("torch", tmp_path / "crash", total=9)
    t1.init_fresh()
    with pytest.raises(RuntimeError, match="injected crash"):
        t1.run(crash_at=5)
    t2, _ = _trainer("torch", tmp_path / "crash", store=store, total=9)
    assert t2.try_restore() and t2.step == 3
    t2.run()
    assert t2.step == 9
    assert t2.state_fingerprint() == ref.state_fingerprint()


def test_trainer_and_launcher_default_to_the_card(tmp_path):
    from repro_torch.launch import train

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    store = TKV(STORE, T_DVV, network=TNet(seed=0), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.Trainer(TModelConfig(**TINY), TAdamW(), TPipe(128, 16, 4),
                   TT.TrainerConfig(), TCkpt(store, str(tmp_path), "r",
                                             "s1"))
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "gemma-2b", "--smoke", "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])


def test_train_launcher_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    args = ["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--steps",
            "4", "--seq-len", "16", "--global-batch", "2", "--ckpt-every",
            "2", "--ckpt-dir", str(tmp_path)]
    assert train.main(args) == 0
    out = capsys.readouterr()
    assert "fresh run gemma-2b-smoke-train" in out.out
    assert "step      4" in out.out and "WARNING" not in out.err
    assert any(f.endswith(".npy") for f in (p.name
                                            for p in tmp_path.iterdir()))


# ---------------------------------------------------------------------------
# the control plane around training, on both packages
# ---------------------------------------------------------------------------

def _sims(tmp_path, total):
    cfg = dict(n_workers=4,
               trainer_cfg=None, blob_root=None,
               mesh_candidates=[((4,), ("data",)), ((2,), ("data",)),
                                ((1,), ("data",))])
    out = []
    for pkg, (Sim, MC, Adam, Pipe, TCfg) in (
            ("jax", (JSim, JModelConfig, JAdamW, JPipe, JT.TrainerConfig)),
            ("torch", (TSim, TModelConfig, TAdamW, TPipe,
                       TT.TrainerConfig))):
        kw = dict(cfg, model_cfg=MC(**TINY),
                  opt_cfg=Adam(lr=1e-3, warmup_steps=2, total_steps=total),
                  pipe_cfg=Pipe(vocab_size=128, seq_len=16, global_batch=4),
                  trainer_cfg=TCfg(total_steps=total, ckpt_every=5,
                                   log_every=10),
                  blob_root=str(tmp_path / pkg))
        if pkg == "torch":
            kw["device"] = "cpu"
        out.append(Sim(**kw))
    return out


def _sim_state(sim, out):
    return (out["step"], out["live"], out["mesh"], sim.rescales,
            tuple(sim.events))


SIM_SCHEDULES = {
    "steady": (20, [("round", 25)]),
    "death": (40, [("round", 5), ("kill", "w3"), ("kill", "w2"),
                   ("round", 20)]),
    "stall": (40, [("round", 4), ("stall", "w1"), ("round", 12)]),
    "recovery": (60, [("round", 3), ("kill", "w3"), ("round", 15),
                      ("recover", "w3"), ("round", 4)]),
}


@pytest.mark.parametrize("schedule", list(SIM_SCHEDULES))
def test_simcluster_twin(tmp_path, schedule):
    """The scenarios of tests/test_simcluster.py on both packages: the same
    events, steps, live counts, meshes and rescales after every round."""
    total, steps = SIM_SCHEDULES[schedule]
    sims = _sims(tmp_path, total)
    for op, arg in steps:
        for _ in range(arg if op == "round" else 1):
            seen = []
            for sim in sims:
                if op == "round":
                    seen.append(_sim_state(sim, sim.round()))
                else:
                    getattr(sim, op)(arg)
                    seen.append(tuple(sim.events))
            assert seen[0] == seen[1]
    jsim, tsim = sims
    assert set(tsim.fd.alive(tsim.now)) == set(jsim.fd.alive(jsim.now))
    assert tsim.membership.view().alive() == jsim.membership.view().alive()
    if schedule == "death":
        assert tsim.assignment.mesh_shape == (2,) and tsim.rescales >= 1
    if schedule == "recovery":
        assert tsim.assignment.mesh_shape == (4,)


def _steal(pkg):
    """tests/test_straggler_training.py's exactly-once schedule."""
    if pkg == "jax":
        from repro.cluster import FailureDetector, WorkStealer
        store = JKV(STORE, J_DVV, network=JNet(seed=0))
    else:
        from repro_torch.cluster import FailureDetector, WorkStealer
        store = TKV(STORE, T_DVV, network=TNet(seed=0), device="cpu")
    shards = [f"shard-{i}" for i in range(12)]
    workers = {w: WorkStealer(store, w, lease_duration=5.0)
               for w in ("w0", "w1", "w2")}
    fd = FailureDetector(heartbeat_interval=1.0)
    processed, pending, now = {}, set(shards), 0.0
    rng = random.Random(3)
    for _ in range(40):
        now += 1.0
        for w, stealer in workers.items():
            if w == "w1" and now > 3.0:
                continue
            fd.record(w, now)
            for shard in sorted(pending):
                owner = stealer.owner(shard, via=rng.choice(STORE))
                claimed = False
                if owner is None or owner == w:
                    claimed = stealer.try_claim(shard, now,
                                                via=rng.choice(STORE))
                elif owner in fd.suspects(now) or owner in fd.dead(now):
                    claimed = stealer.steal_expired(shard, now,
                                                    via=rng.choice(STORE))
                if claimed:
                    if shard not in processed:
                        processed[shard] = w
                        pending.discard(shard)
                    break
        if not pending:
            break
    return processed, pending


def _split_brain(pkg):
    if pkg == "jax":
        from repro.cluster import WorkStealer
        net = JNet(seed=1)
        store = JKV(STORE, J_DVV, network=net)
    else:
        from repro_torch.cluster import WorkStealer
        net = TNet(seed=1)
        store = TKV(STORE, T_DVV, network=net, device="cpu")
    w0 = WorkStealer(store, "w0", lease_duration=100.0)
    w1 = WorkStealer(store, "w1", lease_duration=100.0)
    net.partition({"s1"}, {"s2", "s3"})
    claims = (w0.try_claim("shard-X", now=0.0, via="s1"),
              w1.try_claim("shard-X", now=0.0, via="s2"))
    net.heal()
    store.antientropy_round()
    owner = w0.owner("shard-X", via="s1")
    loser = w1 if owner == "w0" else w0
    return (claims, owner, w1.owner("shard-X", via="s3"),
            loser.renew("shard-X", now=1.0, via="s1"))


def test_straggler_work_stealing_twin():
    processed, pending = _steal("torch")
    assert not pending and len(processed) == 12
    assert sum(1 for w in processed.values() if w == "w1") <= 3
    assert (processed, pending) == _steal("jax")


def test_split_brain_lease_twin():
    got = _split_brain("torch")
    assert got == _split_brain("jax")
    claims, owner, owner_s3, renewed = got
    assert claims == (True, True) and owner == owner_s3 in ("w0", "w1")
    assert not renewed
