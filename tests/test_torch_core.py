"""The port's clock algebra against the JAX package's.

The torch functions of ``repro_torch.core.batched`` (the plain versions of
the CUDA kernels) get the same numpy inputs as the jnp functions of
``repro.core.batched`` and must give exactly equal outputs; the copied
pure-Python clocks must agree with the reference's clocks by value.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DVV as RefDVV
from repro.core import DVV_MECHANISM as REF_MECH
from repro.core import batched as RB
from repro.core import sync as ref_sync
from repro.core import update as ref_update
from repro_torch.core import DVV, DVV_MECHANISM, sync, update
from repro_torch.core import batched as TB

pytestmark = pytest.mark.torch


def _rand_comps(rng, universe):
    comps = []
    for r in universe:
        if rng.random() < 0.6:
            m = rng.randint(0, 6)
            if m > 0:
                comps.append([r, m, 0])
    if comps and rng.random() < 0.7:
        i = rng.randrange(len(comps))
        comps[i][2] = comps[i][1] + rng.randint(1, 3)
    return tuple(tuple(c) for c in comps)


def _pairs(seed, n, R):
    """Encoded clock pairs (numpy) plus the port's clock objects."""
    rng = random.Random(seed)
    universe = [f"r{i}" for i in range(R)]
    xs = [DVV(_rand_comps(rng, universe)) for _ in range(n)]
    ys = [DVV(_rand_comps(rng, universe)) for _ in range(n)]
    return (TB.encode_batch(xs, universe) + TB.encode_batch(ys, universe),
            xs, ys)


def _t(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("R", [0, 1, 3, 9])
def test_leq_dominates_concurrent_match_jnp(R):
    (vx, ix, nx, vy, iy, ny), xs, ys = _pairs(R + 11, 120, R)
    args = (vx, ix, nx, vy, iy, ny)
    for name in ("leq", "dominates", "concurrent"):
        got = getattr(TB, name)(*_t(args)).numpy()
        want = np.asarray(getattr(RB, name)(*_j(args)))
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(
        TB.leq(*_t(args)).numpy(), [x.leq(y) for x, y in zip(xs, ys)])
    np.testing.assert_array_equal(
        TB.leq(*_t(args)).numpy(), RB.leq_np(*args))


def test_leq_empty_universe_is_all_true_with_broadcast_shape():
    z = torch.zeros((4, 1, 0), dtype=torch.int32)
    ix = torch.full((4, 1), -1, dtype=torch.int32)
    iy = torch.full((1, 3), -1, dtype=torch.int32)
    out = TB.leq(z, ix, ix, z.transpose(0, 1), iy, iy)
    assert out.shape == (4, 3) and bool(out.all())


def _grouped(seed, N, K, R):
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


@pytest.mark.parametrize("shape", [(1, 1, 1), (7, 3, 0), (23, 4, 5),
                                   (64, 6, 13)])
def test_sync_mask_and_merge_context_match_jnp(shape):
    args = _grouped(sum(shape), *shape)
    got = TB.sync_mask(*_t(args)).numpy()
    np.testing.assert_array_equal(got, np.asarray(RB.sync_mask(*_j(args))))
    np.testing.assert_array_equal(got, TB.sync_mask_np(*args))
    vvs, dids, dns, valid = args
    np.testing.assert_array_equal(
        TB.effective_vv(*_t((vvs, dids, dns))).numpy(),
        np.asarray(RB.effective_vv(*_j((vvs, dids, dns)))))
    np.testing.assert_array_equal(
        TB.merge_context(*_t(args)).numpy(),
        np.asarray(RB.merge_context(*_j(args))))


def test_effective_vv_folds_the_dot_unconditionally():
    """The reference folds max(vv, n) at the dot even where n > vv + 1
    (its code, not its docstring, is the reference)."""
    vv = np.array([[1, 0, 2]], np.int32)
    did = np.array([1], np.int32)
    dn = np.array([5], np.int32)
    got = TB.effective_vv(*_t((vv, did, dn))).numpy()
    np.testing.assert_array_equal(got, [[1, 5, 2]])
    np.testing.assert_array_equal(
        got, np.asarray(RB.effective_vv(*_j((vv, did, dn)))))


def test_update_clock_matches_jnp():
    rng = np.random.default_rng(3)
    ctx = rng.integers(0, 9, (11, 4)).astype(np.int32)
    local = rng.integers(-2, 9, 11).astype(np.int32)
    r = rng.integers(0, 4, 11).astype(np.int32)
    for a, b in zip(TB.update_clock(*_t((ctx, local, r))),
                    RB.update_clock(*_j((ctx, local, r)))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_numpy_twins_and_codec_match_reference():
    args = _grouped(5, 40, 5, 6)
    np.testing.assert_array_equal(TB.sync_mask_np(*args),
                                  RB.sync_mask_np(*args))
    vvs, dids, dns, valid = args
    rows = vvs.reshape(-1, 6)
    groups = np.random.default_rng(6).integers(0, 9, len(rows))
    np.testing.assert_array_equal(
        TB.grouped_ceiling_np(rows, dids.ravel(), dns.ravel(), groups, 9),
        RB.grouped_ceiling_np(rows, dids.ravel(), dns.ravel(), groups, 9))
    universe = ["a", "b", "c"]
    clock = DVV((("a", 2, 0), ("c", 1, 4)))
    ref_clock = RB.decode(*RB.encode(RefDVV(clock.components), universe),
                          universe)
    assert TB.decode(*TB.encode(clock, universe), universe).components \
        == ref_clock.components


def _outcome(fn, *args):
    try:
        return repr(fn(*args))
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("seed", range(4))
def test_copied_clocks_sync_and_update_match_reference(seed):
    rng = random.Random(seed)
    universe = ["a", "b", "c", "d"]
    comps = [_rand_comps(rng, universe) for _ in range(12)]
    S1, S2 = frozenset(map(DVV, comps[:6])), frozenset(map(DVV, comps[6:]))
    R1 = frozenset(RefDVV(c) for c in comps[:6])
    R2 = frozenset(RefDVV(c) for c in comps[6:])
    assert {c.components for c in sync(S1, S2)} == \
        {c.components for c in ref_sync(R1, R2)}
    for r in universe:
        # arbitrary sets need not be downsets, so both sides may refuse
        assert _outcome(update, S1, S2, r) == \
            _outcome(ref_update, R1, R2, r)
        assert _outcome(DVV_MECHANISM.update, S1, S2, r, "c", 1, 0.0) == \
            _outcome(REF_MECH.update, R1, R2, r, "c", 1, 0.0)
    for x in S1:
        for y in S2:
            rx, ry = RefDVV(x.components), RefDVV(y.components)
            assert (x.leq(y), x.concurrent(y), repr(x)) == \
                (rx.leq(ry), rx.concurrent(ry), repr(rx))


def test_bucketed_sync_mask_on_cpu_counts_and_pads():
    m = TB.BucketedSyncMask(device="cpu")
    for shape in [(5, 2, 3), (7, 2, 5), (8, 2, 8), (100, 2, 5)]:
        args = _grouped(sum(shape), *shape)
        np.testing.assert_array_equal(m(*args), TB.sync_mask_np(*args))
    info = m.cache_info()
    assert info["misses"] == 2 and info["hits"] == 2, info
    assert TB.bucket_shape(5, 2, 3) in info["buckets"]
    m.reset_stats()
    assert m.cache_info()["hits"] == 0 and m.cache_info()["buckets"]
    assert TB.bucket_shape(9, 3, 9) == RB.bucket_shape(9, 3, 9)
