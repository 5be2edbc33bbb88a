"""Activation-sharding context: the constraints the model applies when it
runs on a mesh (the dry run, ``launch/dryrun.py``).

The model code stays mesh-agnostic: constraints are expressed as logical
axes ("batch" / "model" / "tp" / "tpd" / None per dim) and resolve against
whatever mesh the launcher installed via ``activation_sharding``.  With no
context installed (every path on the card, the unit tests) or on a tensor
that is not a ``DTensor``, ``constrain`` returns its input itself.

On a mesh, ``constrain`` redistributes the ``DTensor`` to the placements
the JAX package's rules give for the same logical axes (its
``with_sharding_constraint``): a dim names the mesh axes it is sharded
over, every other mesh axis is replicated, so a partial sum is reduced and
a sharding the rules do not name is gathered.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Sequence, Tuple

import torch

_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "activation_sharding", default=None)


@contextlib.contextmanager
def activation_sharding(mesh, batch_axes: Sequence[str],
                        model_axis: str = "model",
                        replicate_batch: bool = False):
    """``replicate_batch=True`` (decode_tp mode): "batch" constraints
    resolve to replicated — decode activations are KB-scale and weights are
    stationary 2-D sharded, so moving activations beats gathering weights.
    In this mode the logical axes "tp" (full data×model tensor axis) and
    "tpd" (the data part only) become active: the model pins its decode
    activations to the weight layout so the contractions reduce
    activation-sized partial sums instead of gathering weights; outside
    decode_tp a call that names either leaves its tensor as it is."""
    token = _CTX.set((mesh, tuple(batch_axes), model_axis, replicate_batch))
    try:
        yield
    finally:
        _CTX.reset(token)


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def logical_spec(shape: Sequence[int], logical: Sequence[Optional[str]],
                 mesh, batch_axes: Sequence[str], model_axis: str,
                 replicate_batch: bool) -> Optional[Tuple]:
    """The partition spec (one entry per dim: None, an axis name or a tuple
    of axis names) the JAX package's ``constrain`` gives ``logical`` on a
    tensor of ``shape``; None where it leaves the tensor alone ("tp"/"tpd"
    outside decode_tp).  Indivisible dims degrade to replicated."""
    sizes = _sizes(mesh)
    assert len(logical) == len(shape), (logical, shape)
    if not replicate_batch and any(n in ("tp", "tpd") for n in logical):
        # "tp"/"tpd" call sites exist purely for decode_tp mode; outside it
        # they must not constrain AT ALL (a partial constraint here would
        # fight the train-mode layout)
        return None
    batch_size = math.prod(sizes[a] for a in batch_axes)
    batch_entry = tuple(batch_axes) if len(batch_axes) > 1 \
        else batch_axes[0]
    spec = []
    for name, dim in zip(logical, shape):
        if name == "batch":
            if replicate_batch:
                spec.append(None)
            elif dim % batch_size == 0:
                spec.append(batch_entry)
            elif len(batch_axes) > 1 and dim % sizes[batch_axes[-1]] == 0:
                spec.append(batch_axes[-1])
            else:
                spec.append(None)
        elif name == "model":
            spec.append(model_axis if dim % sizes[model_axis] == 0
                        else None)
        elif name == "tp":          # active only in decode_tp mode
            axes = tuple(batch_axes) + (model_axis,)
            size = math.prod(sizes[a] for a in axes)
            spec.append(axes if dim % size == 0 else None)
        elif name == "tpd":         # the data part of the tensor axis
            spec.append(batch_entry if dim % batch_size == 0 else None)
        else:
            spec.append(None)
    return tuple(spec)


def placements(spec: Sequence, mesh) -> Tuple:
    """DTensor placements of a partition spec on ``mesh``: mesh dim ``i``
    is ``Shard(d)`` when tensor dim ``d``'s entry names its axis, else
    ``Replicate()``.  A dim sharded over several axes (("pod", "data"))
    shards on each of those mesh dims; its axes must come in the mesh's
    order, major first, which is DTensor's order of nested shards and
    JAX's, so the local shards are the same."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    owner = {}
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {d} are not in the "
                             f"mesh's order {names}")
        for a in axes:
            if a in owner:
                raise ValueError(f"axis {a!r} shards dims {owner[a]} and "
                                 f"{d} of {tuple(spec)}")
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in names)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Apply a logical sharding constraint to a ``DTensor``; any other
    tensor, and any tensor with no context installed, is returned as it
    is."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh, batch_axes, model_axis, replicate_batch = ctx
    spec = logical_spec(x.shape, logical, mesh, batch_axes, model_axis,
                        replicate_batch)
    if spec is None:
        return x
    want = placements(spec, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)
