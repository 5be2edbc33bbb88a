"""The plain torch version of decode attention: the JAX package's math
(``src/repro/models/attention.py:192``, ``decode_attention``) over the whole
cache, the positions past ``pos`` (and before a sliding window) masked with
``NEG_INF`` after the product.  The front end (``ops.decode_attend``) takes
it for tensors on the CPU (and the meta device); the tests and
``chip_smoke.py`` hold the CUDA kernel against it on the card."""
from __future__ import annotations

from typing import Optional

import torch

#: The JAX package's masked score; ``models/attention.py`` imports it.
NEG_INF = -2.0e38


def live_keys(pos: int, window: int = 0) -> range:
    """The positions a query at ``pos`` attends to: ``lo..pos``, with
    ``lo = max(0, pos - window + 1)`` under a sliding window, else 0."""
    return range(max(0, pos - window + 1) if window else 0, pos + 1)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos: int, *, window: int = 0, softcap: float = 0.0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q [B,1,KV,G,D] (the query heads grouped by their KV head, as
    ``models.attention._group_q`` gives them); k, v [B,Smax,KV,D] ->
    [B,1,KV,G,D] in q's dtype.  Scores are rounded to q's dtype by the
    product and raised to fp32; the probabilities are rounded to q's dtype
    before the second product, as in the JAX package."""
    Smax, D = k.shape[1], q.shape[-1]
    scores = torch.einsum("bqkgh,bskh->bkgqs", q,
                          k.to(q.dtype)).float() * (scale or D ** -0.5)
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    kpos = torch.arange(Smax, dtype=torch.int32, device=q.device)
    ok = kpos <= pos
    if window:
        ok &= kpos > pos - window
    scores = torch.where(ok, scores, torch.tensor(
        NEG_INF, dtype=torch.float32, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v.to(q.dtype))
