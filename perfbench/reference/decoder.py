"""The plain reference: a causal decoder in plain PyTorch, float32 with
TF32 off, written from the published description of the model family and
not from the port.

One layer is an RMSNorm, grouped-query attention with interleaved-pair
RoPE, an optional tanh softcap on the scores and causal masking, then an
RMSNorm and either a gated MLP (SwiGLU, or GeGLU with the tanh GeLU) or a
mixture of experts: a float32 router, softmax, the top ``moe_topk``
experts with their gates renormalised, and the capacity rule of GShard and
Mesh-TensorFlow (a group's expert keeps its first ``capacity``
assignments, counted slot by slot; a dropped assignment adds nothing).
The embedding is scaled by sqrt(d_model) where ``embed_scale`` says so;
the head is the embedding's transpose where it is tied.

It reads the configuration's ``model`` sizes and the weights the
benchmark drew (the port's parameter layout: stacked over groups, bf16),
casts each weight to float32 where it uses it, and computes layer by
layer over all the sequences it is given, in blocks of rows, so that it
fits beside the weights.  ``precision="fp8"`` is the control: every
matrix product's operands rounded to float8 e4m3 with a scale per row of
the left operand and per column of the right one (the router excepted),
float32 accumulation.

It imports nothing but torch.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import List, Mapping, Sequence

import torch
import torch.nn.functional as F

ROWS = 8192            # rows of activations a block
Q_ROWS = 512           # query rows a block of attention
E4M3_MAX = 448.0


@contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the slice's largest magnitude maps to 448), back in float32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    s = amax / E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


class Reference:
    def __init__(self, model: Mapping, weights: Mapping,
                 precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(precision)
        self.m = model
        self.w = weights
        self.fp8 = precision == "fp8"

    # -- pieces -------------------------------------------------------------
    def weight(self, b: torch.Tensor) -> torch.Tensor:
        """A right operand [k, n] as the products take it: float32, or
        for the control rounded to float8 with a scale per column."""
        b = b.float()
        return q8(b, 0) if self.fp8 else b

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a [..., k] @ b [k, n] in float32 (float8 operands for the
        control); ``b`` as ``weight`` gives it."""
        a = a.float()
        return (q8(a, -1) if self.fp8 else a) @ b

    @staticmethod
    def rms(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) \
            * w.float()

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Rotate the pairs (2i, 2i+1) of x [S, h, D] by pos * theta **
        (-2i / D), angles in float32."""
        D = x.shape[-1]
        k = torch.arange(D // 2, dtype=torch.float32, device=x.device)
        inv = 1.0 / (self.m.get("rope_theta", 10000.0) ** (2.0 * k / D))
        ang = pos.float()[:, None] * inv
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        xe, xo = x[..., 0::2], x[..., 1::2]
        return torch.stack([xe * cos - xo * sin, xo * cos + xe * sin],
                           -1).reshape(x.shape)

    def attention(self, w: Mapping, h: torch.Tensor) -> torch.Tensor:
        m = self.m
        S, d = h.shape
        H, KV, D = m["n_heads"], m["n_kv_heads"], m["head_dim"]
        G = H // KV
        pos = torch.arange(S, device=h.device)

        def project(name, heads):
            return self.mm(h, self.weight(w[name].reshape(d, heads * D))
                           ).view(S, heads, D)

        q = self.rope(project("wq", H), pos)
        k = self.rope(project("wk", KV), pos)
        v = project("wv", KV)
        if self.fp8:
            q, k = q8(q, -1), q8(k, -1)
        cap = m.get("attn_softcap", 0.0)
        out = torch.empty((S, KV, G, D), dtype=torch.float32,
                          device=h.device)
        for a in range(0, S, Q_ROWS):
            b = min(S, a + Q_ROWS)
            qb = q[a:b].view(b - a, KV, G, D)
            s = torch.einsum("qkgd,tkd->kgqt", qb, k[:b]) * D ** -0.5
            if cap:
                s = cap * torch.tanh(s / cap)
            mask = torch.arange(b, device=h.device)[None, :] > \
                torch.arange(a, b, device=h.device)[:, None]
            s = s.masked_fill(mask, float("-inf"))
            p = torch.softmax(s, dim=-1)
            vb = v[:b]
            if self.fp8:
                p, vb = q8(p, -1), q8(vb, 0)
            out[a:b] = torch.einsum("kgqt,tkd->qkgd", p, vb)
        return self.mm(out.reshape(S, H * D),
                       self.weight(w["wo"].reshape(H * D, d)))

    def act(self, g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        if self.m.get("act", "swiglu") == "geglu":
            return F.gelu(g, approximate="tanh") * u
        return F.silu(g) * u

    def ffn(self, wg, wu, wd, x: torch.Tensor) -> torch.Tensor:
        return self.mm(self.act(self.mm(x, wg), self.mm(x, wu)), wd)

    def mlp(self, w: Mapping, h: torch.Tensor) -> torch.Tensor:
        wg, wu, wd = (self.weight(w[k])
                      for k in ("w_gate", "w_up", "w_down"))
        return torch.cat([self.ffn(wg, wu, wd, h[a:a + ROWS])
                          for a in range(0, h.shape[0], ROWS)])

    def capacity(self, S: int) -> int:
        m = self.m
        c = int(S * m["moe_topk"] * m["capacity_factor"] / m["moe_experts"])
        return max(8, -(-c // 8) * 8)

    def routes(self, w: Mapping, h: torch.Tensor, per_token: bool):
        """Each token's experts [S, K], renormalised gates [S, K] and
        whether each assignment is kept [S, K].  A sequence is one group
        (``per_token``: every token is its own group, which keeps all)."""
        m = self.m
        E, K = m["moe_experts"], m["moe_topk"]
        probs = torch.softmax(h.float() @ w["router"].float(), dim=-1)
        gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, idx = gates[:, :K], idx[:, :K]
        gates = gates / gates.sum(-1, keepdim=True)
        if per_token:
            return idx, gates, torch.ones_like(idx, dtype=torch.bool)
        C = self.capacity(h.shape[0])
        filled = torch.zeros(E, dtype=torch.int64, device=h.device)
        kept = []
        for k in range(K):
            onehot = F.one_hot(idx[:, k], E)
            place = (torch.cumsum(onehot, 0) - 1 + filled).gather(
                1, idx[:, k:k + 1])[:, 0]
            kept.append(place < C)
            filled += onehot.sum(0)
        return idx, gates, torch.stack(kept, 1)

    def moe(self, w: Mapping, hs: List[torch.Tensor], per_token: bool
            ) -> List[torch.Tensor]:
        routes = [self.routes(w, h, per_token) for h in hs]
        outs = [torch.zeros_like(h) for h in hs]
        for e in range(self.m["moe_experts"]):
            wg, wu, wd = (self.weight(w[k][e])
                          for k in ("w_gate", "w_up", "w_down"))
            for h, out, (idx, gates, kept) in zip(hs, outs, routes):
                hit = (idx == e) & kept
                rows, slot = hit.nonzero(as_tuple=True)
                for a in range(0, rows.numel(), ROWS):
                    r = rows[a:a + ROWS]
                    y = self.ffn(wg, wu, wd, h[r])
                    out.index_add_(0, r, gates[r, slot[a:a + ROWS],
                                               None] * y)
            del wg, wu, wd
        return outs

    # -- the model ----------------------------------------------------------
    def logits(self, sequences: Sequence[torch.Tensor],
               keep: Sequence[torch.Tensor], *, per_token_groups: bool
               ) -> List[torch.Tensor]:
        """The logits [len(keep[i]), V] at positions ``keep[i]`` of each
        causal sequence of tokens ``sequences[i]`` (positions from 0).
        ``per_token_groups`` routes every token as its own MoE group (the
        decode step's groups) instead of a sequence as one."""
        m, W = self.m, self.w
        with no_tf32(), torch.no_grad():
            embed = W["embed"]
            xs = [embed[s.long()].float() for s in sequences]
            if m.get("embed_scale"):
                xs = [x * math.sqrt(m["d_model"]) for x in xs]
            pattern = m["pattern"]
            for g in range(m["n_layers"] // len(pattern)):
                for i, (mixer, ffn) in enumerate(pattern):
                    L = _index(W["blocks"][f"layer{i}"], g)
                    if mixer != "attn":
                        raise ValueError(f"no reference for {mixer!r}")
                    xs = [x + self.attention(L["attn"],
                                             self.rms(x, L["pre_norm"]))
                          for x in xs]
                    if ffn == "mlp":
                        xs = [x + self.mlp(L["mlp"],
                                           self.rms(x, L["ffn_norm"]))
                              for x in xs]
                    elif ffn == "moe":
                        hs = [self.rms(x, L["ffn_norm"]) for x in xs]
                        xs = [x + o for x, o in zip(
                            xs, self.moe(L["moe"], hs, per_token_groups))]
                    elif ffn != "none":
                        raise ValueError(ffn)
            head = self.weight(embed.T if m.get("tie_embeddings", True)
                               else W["unembed"])
            out = []
            for x, pos in zip(xs, keep):
                h = self.rms(x[pos], W["final_norm"])
                out.append(torch.cat([
                    self.mm(h[a:a + 1024], head)
                    for a in range(0, h.shape[0], 1024)]))
            return out


def _index(tree, g: int):
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]
