"""The port's MoE FFN (``repro_torch.models.moe``) on the CPU against the
JAX package's ``repro.models.moe``, on the same numpy inputs and the same
parameters:

  * ``moe_ffn``'s output, ``aux_loss`` and ``z_loss`` within 1e-5 in fp32
    and 0.05 in bf16 (the bound of ``tests/test_kernels.py:224``), and
    ``fraction_dropped`` exactly, for (E, K) in {(4, 2), (8, 1), (16, 8)},
    on an input whose skewed routing overflows some experts and on one
    whose capacity holds every token;
  * ties: with the router zeroed every probability is equal, and both
    packages choose experts 0..K-1 (``lax.top_k``'s order);
  * ``capacity`` for every group size from 1 to 9,000;
  * ``init_moe_params``'s names, shapes and dtypes against
    ``jax.eval_shape`` of the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro_torch.models import moe as TM

pytestmark = pytest.mark.torch

EXPERTS = [(4, 2), (8, 1), (16, 8)]
D_MODEL, D_FF, G, S = 32, 24, 2, 64
#: max abs difference of out, aux_loss and z_loss
TOL = {"float32": 1e-5, "bfloat16": 0.05}


def _specs(E, K, **kw):
    spec = JM.MoESpec(n_experts=E, top_k=K, d_ff=D_FF, **kw)
    return spec, TM.MoESpec(**vars(spec))


def _params(spec, seed=0, dtype=jnp.float32):
    jp = JM.init_moe_params(jax.random.key(seed), D_MODEL, spec, dtype)
    return jp, {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        getattr(torch, str(v.dtype))) for k, v in jp.items()}


def _x(case, seed=1):
    """[G, S, d]: "drops" adds one shared direction to every token, so the
    router favours a few experts past their capacity, and scales the sum
    back to about unit size (outputs stay below 4, where a bf16 step is
    finer than the bf16 bound); "no_drops" is plain noise (its spec's
    capacity holds every token anyway)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(G, S, D_MODEL))
    if case == "drops":
        x = 0.3 * (x + 3.0 * rng.normal(size=(D_MODEL,)))
    return x.astype(np.float32)


def _both(jp, tp, x, spec, tspec, dtype):
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jout, jm = JM.moe_ffn(jp, jx, spec)
    tout, tm = TM.moe_ffn(tp, tx, tspec)
    assert tout.dtype == tx.dtype and tout.shape == tx.shape
    return (np.asarray(jout.astype(jnp.float32)), tout.float().numpy(),
            {k: np.asarray(v) for k, v in jm.items()},
            {k: v.numpy() for k, v in tm.items()})


@pytest.mark.parametrize("E,K", EXPERTS)
@pytest.mark.parametrize("case", ["drops", "no_drops"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_jax(E, K, case, dtype):
    # "no_drops": capacity_factor E / K gives every expert room for all S
    # tokens, and a token names an expert at most once
    spec, tspec = _specs(E, K, **({"capacity_factor": E / K}
                                  if case == "no_drops" else {}))
    jp, tp = _params(spec, dtype=getattr(jnp, dtype))
    want, got, jm, tm = _both(jp, tp, _x(case), spec, tspec, dtype)
    assert np.abs(got - want).max() <= TOL[dtype]
    for key in ("aux_loss", "z_loss"):
        assert abs(float(tm[key]) - float(jm[key])) <= TOL[dtype], key
    assert tm["fraction_dropped"].dtype == np.float32
    assert tm["fraction_dropped"] == jm["fraction_dropped"]
    dropped = float(tm["fraction_dropped"])
    assert (0.0 < dropped < 1.0) if case == "drops" else dropped == 0.0


@pytest.mark.parametrize("E,K", EXPERTS)
def test_ties_choose_the_lower_experts_first(E, K):
    """A zeroed router makes every probability 1/E: ``lax.top_k`` takes
    experts 0..K-1 for every token, and so must the port; every token then
    queues for the same K experts, which drop all but C of them."""
    spec, tspec = _specs(E, K)
    jp, tp = _params(spec, seed=2)
    jp["router"] = jnp.zeros_like(jp["router"])
    tp["router"] = torch.zeros_like(tp["router"])
    x = _x("no_drops", seed=3)
    _, _, _, idx = TM.route(tp, torch.from_numpy(x), tspec)
    assert torch.equal(idx, torch.arange(K).expand(G, S, K))
    _, jidx = jax.lax.top_k(jnp.full((G, S, E), 1.0 / E), K)
    np.testing.assert_array_equal(np.asarray(jidx), idx.numpy())
    want, got, jm, tm = _both(jp, tp, x, spec, tspec, "float32")
    assert np.abs(got - want).max() <= TOL["float32"]
    C = TM.capacity(S, tspec)
    assert tm["fraction_dropped"] == jm["fraction_dropped"] == np.float32(
        1.0 - min(C, S) * K / (S * K))


def test_capacity_matches_jax_for_every_group_size():
    specs = [_specs(E, K, capacity_factor=cf) for E, K in
             EXPERTS + [(128, 8)] for cf in (1.25, 1.0, 2.0)]
    for n in range(1, 9001):
        for spec, tspec in specs:
            assert TM.capacity(n, tspec) == JM.capacity(n, spec)
    assert TM.capacity(4096, _specs(128, 8)[1]) == 320       # qwen3-moe
    assert TM.capacity(1, _specs(128, 8)[1]) == 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_moe_params_has_the_jax_shapes_and_dtypes(dtype):
    """Names, shapes and dtypes (the router fp32 whatever the dtype), with
    and without stacking axes; each stacked index is a draw of its own."""
    spec, tspec = _specs(16, 8)
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in jax.eval_shape(
        lambda: JM.init_moe_params(jax.random.key(0), D_MODEL, spec,
                                   getattr(jnp, dtype))).items()}
    gen = torch.Generator().manual_seed(0)
    flat = TM.init_moe_params(gen, D_MODEL, tspec, getattr(torch, dtype))
    stacked = TM.init_moe_params(gen, D_MODEL, tspec, getattr(torch, dtype),
                                 lead=(2, 3))

    def dt(t):
        return str(t.dtype).replace("torch.", "")

    assert {k: (tuple(v.shape), dt(v)) for k, v in flat.items()} == want
    assert {k: (tuple(v.shape[2:]), dt(v)) for k, v in stacked.items()} \
        == want
    assert all(v.shape[:2] == (2, 3) for v in stacked.values())
    w = stacked["w_gate"].float()
    assert not torch.equal(w[0, 0], w[1, 2])
    # the scales: d_model ** -0.5 in, d_ff ** -0.5 out
    assert abs(float(w.std()) - D_MODEL ** -0.5) < 0.02
    assert abs(float(stacked["w_down"].float().std()) - D_FF ** -0.5) < 0.02


def _per_slot_loop(idx, gates, E, C):
    """numpy transcription of the JAX package's per-slot loop
    (``repro/models/moe.py``): slot k's one-hot [G,S,E], its cumulative
    sum over the group plus the occupancy ``base`` of slots < k."""
    G, S, K = idx.shape
    dispatch = np.zeros((G, S, E, C), np.float32)
    combine = np.zeros((G, S, E, C), np.float32)
    base = np.zeros((G, E), np.int64)
    kept = 0
    for k in range(K):
        sel = np.eye(E, dtype=np.int64)[idx[..., k]]
        pos = np.cumsum(sel, axis=1) * sel - 1 + base[:, None, :] * sel
        within = (sel > 0) & (pos < C)
        disp = np.eye(C, dtype=np.float32)[np.clip(pos, 0, C - 1)] \
            * within[..., None]
        dispatch += disp
        combine += gates[..., k, None, None] * disp
        base += sel.sum(axis=1)
        kept += int(within.sum())
    return dispatch, combine, kept


@pytest.mark.parametrize("G,S,E,K,C", [(3, 50, 6, 3, 8), (2, 40, 16, 8, 16),
                                       (1, 9, 4, 4, 8)])
def test_assign_equals_the_per_slot_loop(G, S, E, K, C):
    """``assign``'s one stable sort against the JAX package's loop over
    slots, on random distinct expert choices that overflow most experts:
    the same dispatch and combine tensors and the same kept count."""
    rng = np.random.default_rng([G, S, E, K])
    idx = np.argsort(rng.random((G, S, E)), axis=-1)[..., :K]
    gates = rng.random((G, S, K)).astype(np.float32)
    want = _per_slot_loop(idx, gates, E, C)
    got = TM.assign(torch.from_numpy(idx), torch.from_numpy(gates), E, C,
                    torch.float32)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert int(got[2]) == want[2] < G * S * K
