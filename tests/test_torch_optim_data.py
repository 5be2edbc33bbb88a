"""The port's optimizer and token pipeline against the JAX package's, on
the same numpy inputs:

  * ``adamw_update`` (all three schedules, clipping on and off, master
    weights, bf16 moments), ``schedule_lr``, ``global_norm`` and
    ``clip_by_global_norm``: fp32 results within 1e-6 of each value
    (relative, 1e-7 absolute floor: the same elementwise operations in the
    same order, where ``pow`` and ``cos`` may round one ulp apart), bf16
    moments within one bf16 step (2^-7 relative, as a one-ulp difference
    before rounding can move the rounding);
  * ``SyntheticTokens`` bitwise (several seeds, cursors, dp ranks and vocab
    sizes on both sides of 2^16, where JAX's two-draw modulus changes) and
    ``MemmapTokens`` bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as JD
from repro import optim as JO
from repro_torch import data as TD
from repro_torch import optim as TO
from repro_torch.optim.adamw import tree_leaves

pytestmark = pytest.mark.torch

RTOL, ATOL = 1e-6, 1e-7


def _tree(seed, scale=1.0):
    """A nested tree whose dict keys sort differently as strings and as
    numbers (layer10 before layer2), with leaves of several shapes."""
    rng = np.random.default_rng(seed)

    def leaf(*shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return {"embed": leaf(6, 4), "final_norm": leaf(4),
            "blocks": {f"layer{i}": {"w": leaf(2, 4, 3), "b": leaf(3)}
                       for i in (0, 2, 10)}}


def _jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _torch(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _torch(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(dtype)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _assert_trees_close(got, want, **kw):
    got_l, want_l = tree_leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, **kw)


CASES = {
    "cosine_clipped": dict(schedule="cosine", grad_clip=1.0),
    "linear_clipped": dict(schedule="linear", grad_clip=0.5),
    "constant_unclipped": dict(schedule="constant", grad_clip=0.0),
    "cosine_master": dict(schedule="cosine", master_weights=True),
    "linear_bf16_moments": dict(schedule="linear", moment_dtype="bfloat16"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_adamw_update_matches_jax(case):
    """Six steps past the warm-up into the decay, gradients scaled so that
    clipping acts on some steps and not on others."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=8, weight_decay=0.1,
               **CASES[case])
    jcfg, tcfg = JO.AdamWConfig(**cfg), TO.AdamWConfig(**cfg)
    params = _tree(0)
    jp, tp = _jax(params), _torch(params)
    js, ts = JO.init_opt_state(jp, jcfg), TO.init_opt_state(tp, tcfg)
    mtol = dict(rtol=2 ** -7, atol=1e-7) if cfg.get("moment_dtype") \
        else {}
    for step in range(6):
        grads = _tree(100 + step, scale=0.2 * (step + 1))
        jp, js, jm = JO.adamw_update(jp, _jax(grads), js, jcfg)
        tp, ts, tm = TO.adamw_update(tp, _torch(grads), ts, tcfg)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        assert ts["step"].dtype == torch.int32
        _close(tm["grad_norm"], jm["grad_norm"])
        _close(tm["lr"], jm["lr"])
        _assert_trees_close(tp, jp, **({"rtol": 1e-5, "atol": 1e-6}
                                       if mtol else {}))
        for part in ("m", "v") + (("master",) if tcfg.master_weights
                                   else ()):
            _assert_trees_close(ts[part], js[part], **mtol)
        for t in tree_leaves(ts["m"]):
            assert t.dtype == getattr(torch, tcfg.moment_dtype)


def test_adamw_master_weights_with_bf16_params_match_jax():
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=5, master_weights=True,
               schedule="constant")
    jcfg, tcfg = JO.AdamWConfig(**cfg), TO.AdamWConfig(**cfg)
    params = _tree(1)
    jp, tp = _jax(params, jnp.bfloat16), _torch(params, torch.bfloat16)
    js, ts = JO.init_opt_state(jp, jcfg), TO.init_opt_state(tp, tcfg)
    for step in range(3):
        grads = _tree(50 + step)
        jp, js, _ = JO.adamw_update(jp, _jax(grads, jnp.bfloat16), js, jcfg)
        tp, ts, _ = TO.adamw_update(tp, _torch(grads, torch.bfloat16), ts,
                                    tcfg)
    for g, w in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert g.dtype == torch.bfloat16
        _close(g, w, rtol=2 ** -7)
    _assert_trees_close(ts["master"], js["master"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("schedule", ["constant", "linear", "cosine"])
def test_schedule_lr_matches_jax(schedule):
    jcfg = JO.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=110,
                          schedule=schedule)
    tcfg = TO.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=110,
                          schedule=schedule)
    for step in (0, 1, 5, 10, 11, 60, 109, 110, 200):
        got = TO.schedule_lr(tcfg, torch.tensor(step, dtype=torch.int32))
        want = JO.schedule_lr(jcfg, jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        _close(got, want)


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_global_norm_and_clip_match_jax(max_norm):
    tree = _tree(3)
    _close(TO.global_norm(_torch(tree)), JO.global_norm(_jax(tree)))
    got, gn = TO.clip_by_global_norm(_torch(tree), max_norm)
    want, wn = JO.clip_by_global_norm(_jax(tree), max_norm)
    _close(gn, wn)
    _assert_trees_close(got, want)


def test_leaves_follow_jax_tree_order():
    tree = _tree(4)
    names = [tuple(float(x) for x in t.flatten()[:2])
             for t in tree_leaves(_torch(tree))]
    want = [tuple(float(x) for x in np.asarray(a).flatten()[:2])
            for a in jax.tree.leaves(tree)]
    assert names == want


# ---------------------------------------------------------------------------
# token pipeline
# ---------------------------------------------------------------------------

PIPES = [
    # (vocab, seq_len, global_batch, dp_rank, dp_size, seed, cursor)
    (256000, 64, 4, 0, 1, 0, 0),          # gemma-2b's vocabulary
    (256, 16, 4, 1, 2, 1, 8),
    (100, 8, 8, 3, 4, 7, 5),
    (50257, 33, 2, 0, 1, 2 ** 31 - 1, 10 ** 6),
    (65536, 9, 2, 0, 1, 3, 2 ** 32 + 3),  # a cursor past 2^32 wraps
    (65537, 9, 3, 2, 3, 5, 7),
    (2 ** 31 - 1, 5, 2, 0, 1, -7, 11),
]


@pytest.mark.parametrize("vocab,seq,batch,rank,size,seed,cursor", PIPES)
def test_synthetic_tokens_bitwise_equal_jax(vocab, seq, batch, rank, size,
                                            seed, cursor):
    a = JD.SyntheticTokens(JD.PipelineConfig(vocab, seq, batch, rank, size,
                                             seed))
    b = TD.SyntheticTokens(TD.PipelineConfig(vocab, seq, batch, rank, size,
                                             seed))
    a.restore(cursor)
    b.restore(cursor)
    for _ in range(3):
        want, got = a.next_batch(), b.next_batch()
        for key in ("tokens", "labels"):
            assert got[key].dtype == want[key].dtype == np.int32
            np.testing.assert_array_equal(got[key], want[key])
        assert a.state() == b.state()


def test_memmap_tokens_bitwise_equal_jax(tmp_path):
    data = np.random.default_rng(0).integers(0, 5000, 10 * 9).astype(
        np.int32)
    path = tmp_path / "toks.bin"
    data.tofile(path)
    for rank in range(2):
        cfg = dict(vocab_size=1000, seq_len=8, global_batch=4,
                   dp_rank=rank, dp_size=2)
        a = JD.MemmapTokens(JD.PipelineConfig(**cfg), str(path))
        b = TD.MemmapTokens(TD.PipelineConfig(**cfg), str(path))
        b.restore(6)
        a.restore(6)
        for _ in range(4):                 # wraps past the tenth sequence
            want, got = a.next_batch(), b.next_batch()
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
            np.testing.assert_array_equal(got["labels"], want["labels"])


def test_memmap_tokens_reject_a_short_file(tmp_path):
    path = tmp_path / "short.bin"
    np.arange(5, dtype=np.int32).tofile(path)
    with pytest.raises(ValueError, match="shorter than one sequence"):
        TD.MemmapTokens(TD.PipelineConfig(100, 8, 1), str(path))
