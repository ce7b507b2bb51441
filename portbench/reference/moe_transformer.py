"""Reference of the decoder-only MoE transformer (granite-moe-1b-a400m).

Plain float32 PyTorch, written from the model's equations; it imports
nothing of the program.  A block is::

    x += Wo . attn(rope(Wq . n1(x)), rope(Wk . n1(x)), Wv . n1(x))
    x += sum over the kept top-k experts e of w_e * SwiGLU_e(n2(x))

with RMSNorm ``n``, causal grouped-query attention, a float32 router whose
top-k softmax weights are renormalised over the chosen experts, and a keep
rule per sequence: an assignment is kept while fewer than the capacity
``max(8, int(S k cf / E))`` earlier assignments of that sequence, in
(position, rank) order, went to its expert.  The last position's logits
are ``n_f(x) . unembed``.

``leaves`` gives the weights' tree (the program's layout: every
``blocks/l0`` leaf stacked over the layers) and how each is drawn;
``forward`` returns the last position's logits, and with ``cache`` each
layer's K (after RoPE) and V.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import roofline
from . import plain


def leaves(m):
    """path -> (shape, init, dtype): ``init`` ("normal", std) or ("scale",)
    (1 + 0.1 N(0, 1)); dtype "act" for the leaves served in the activation
    dtype, "f32" for those the program reads in f32."""
    L, D, H, KV, Dh = (m["n_layers"], m["d_model"], m["n_heads"],
                       m["n_kv_heads"], m["d_head"])
    V, E, Fe = m["vocab_size"], m["n_experts"], m["d_ff_expert"]

    def normal(fan_in):
        return ("normal", 1.0 / math.sqrt(fan_in))

    b = "blocks/l0/"
    return {
        "tok_embed": ((V, D), ("normal", 1.0), "act"),
        "unembed": ((D, V), normal(D), "act"),
        "final_norm": ((D,), ("scale",), "f32"),
        b + "ln1": ((L, D), ("scale",), "f32"),
        b + "attn/wq": ((L, D, H, Dh), normal(D), "act"),
        b + "attn/wk": ((L, D, KV, Dh), normal(D), "act"),
        b + "attn/wv": ((L, D, KV, Dh), normal(D), "act"),
        b + "attn/wo": ((L, H, Dh, D), normal(H * Dh), "act"),
        b + "ln2": ((L, D), ("scale",), "f32"),
        b + "moe/router": ((L, D, E), normal(D), "f32"),
        b + "moe/wi_gate": ((L, E, D, Fe), normal(D), "act"),
        b + "moe/wi_up": ((L, E, D, Fe), normal(D), "act"),
        b + "moe/wo": ((L, E, Fe, D), normal(Fe), "act"),
    }


def capacity(m, S: int) -> int:
    return max(8, int(S * m["top_k"] * m["capacity_factor"]
                      / m["n_experts"]))


def moe(m, p, l: int, h: torch.Tensor, q8, stats):
    """The expert layer on h [B,S,D] (f32), with the keep rule per row."""
    B, S, D = h.shape
    E, k = m["n_experts"], m["top_k"]
    logits = h.reshape(B * S, D) @ p["blocks/l0/moe/router"][l].float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)
    w = w / w.sum(-1, keepdim=True)
    a = idx.reshape(B, S * k)
    onehot = F.one_hot(a, E)
    before = torch.cumsum(onehot, dim=1) - onehot
    keep = torch.gather(before, 2, a[..., None])[..., 0] < capacity(m, S)
    flat = h.reshape(B * S, D)
    rows = torch.arange(B, device=h.device)[:, None] * S \
        + torch.arange(S * k, device=h.device)[None] // k    # token of each
    out = torch.zeros_like(flat)
    wg, wu, wo = (p[f"blocks/l0/moe/{n}"][l] for n in ("wi_gate", "wi_up",
                                                       "wo"))
    a, keep, rows, wf = a.reshape(-1), keep.reshape(-1), rows.reshape(-1), \
        w.reshape(-1)
    used = 0
    for e in range(E):
        sel = torch.nonzero((a == e) & keep)[:, 0]
        if sel.numel() == 0:
            continue
        used += 1
        x = q8(flat[rows[sel]])
        y = (F.silu(x @ q8(wg[e])) * (x @ q8(wu[e])))
        y = q8(y) @ q8(wo[e])
        out.index_add_(0, rows[sel], y * wf[sel, None])
    if stats is not None:
        stats.setdefault("moe_kept", []).append(int(keep.sum()))
        stats.setdefault("moe_used", []).append(used)
    return out.reshape(B, S, D)


def forward(m, p, ids: torch.Tensor, *, precision: str = "float32",
            cache: bool = False, stats: bool = False):
    """ids [B,S] -> {"logits": [B,V] of the last position, "cache": {"k",
    "v": [L,B,S,KV,Dh]} (with ``cache``), "stats": {"moe_kept",
    "moe_used": one count a layer over the batch} (with ``stats``)}."""
    q8 = plain.PRECISIONS[precision]
    B, S = ids.shape
    L, D, H, KV, Dh = (m["n_layers"], m["d_model"], m["n_heads"],
                       m["n_kv_heads"], m["d_head"])
    eps, theta = m["norm_eps"], m["rope_theta"]
    x = q8(p["tok_embed"])[ids]
    ks, vs = [], []
    st = {} if stats else None
    for l in range(L):
        h = q8(plain.rmsnorm(x, p["blocks/l0/ln1"][l], eps))

        def proj(name, heads):
            w = q8(p[f"blocks/l0/attn/{name}"][l]).reshape(D, heads * Dh)
            return (h @ w).reshape(B, S, heads, Dh)

        q = plain.rope(proj("wq", H), theta)
        k = plain.rope(proj("wk", KV), theta)
        v = proj("wv", KV)
        if cache:
            ks.append(k)
            vs.append(v)
        o = plain.causal_gqa(q, k, v, q8).reshape(B, S, H * Dh)
        x = x + q8(o) @ q8(p["blocks/l0/attn/wo"][l]).reshape(H * Dh, D)
        h = plain.rmsnorm(x, p["blocks/l0/ln2"][l], eps)
        x = x + moe(m, p, l, h, q8, st)
    last = plain.rmsnorm(x[:, -1], p["final_norm"], eps)
    out = {"logits": q8(last) @ q8(p["unembed"])}
    if cache:
        out["cache"] = {"k": torch.stack(ks), "v": torch.stack(vs)}
    if stats:
        out["stats"] = st
    return out


def port_cache(kept, S: int):
    """The program's cache of one request, ``{"l0/k", "l0/v": [L, S_max,
    KV, Dh]}``, under the names and lengths of :func:`forward`'s."""
    return {"k": kept["l0/k"][:, :S], "v": kept["l0/v"][:, :S]}


def model_flops(m, B: int, S: int) -> float:
    """A prefill call of B prompts of S tokens: the Q/K/V/O projections,
    the causal attention pairs (QK^T and PV), the f32 router, the top-k
    experts' SwiGLU for every assignment, and the unembed of the last
    position.  2 flops a multiply-add."""
    D, H, KV, Dh = m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_head"]
    T = B * S
    proj = 2 * T * D * (H + 2 * KV) * Dh + 2 * T * H * Dh * D
    attn = 4 * B * H * Dh * roofline.attention_pairs(S, S, True, 0)
    router = 2 * T * D * m["n_experts"]
    experts = T * m["top_k"] * 3 * 2 * D * m["d_ff_expert"]
    unembed = 2 * B * D * m["vocab_size"]
    return m["n_layers"] * (proj + attn + router + experts) + unembed
