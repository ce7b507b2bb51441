"""Reference of the attention-free Mamba2 model (mamba2-780m).

Plain float32 PyTorch, written from the model's equations; it imports
nothing of the program.  A block is ``x += Wout . n_g(y * silu(z))`` with,
from ``h = n1(x)``::

    z = Wz h;  xs = silu(conv(Wx h));  B = silu(conv(Wb h));
    C = silu(conv(Wc h));  dt = softplus(Wdt h + dt_bias);  A = -exp(A_log)
    y = SSD(xs, dt, A, B, C) + D xs

(causal depthwise convolutions of ``ssm_conv`` taps with biases, one B/C
group, heads of ``ssm_head_dim``, the gated norm ``n_g`` over the whole
inner width).  The scan runs by chunks of its own length, 128, not the
program's.  ``leaves`` gives the weights' tree in the program's layout and
how each is drawn, with Mamba2's own draws for ``A_log`` (A uniform in
[1, 16]) and ``dt_bias`` (softplus^-1 of dt log-uniform in [1e-3, 1e-1]).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import roofline
from . import plain

CHUNK = 128


def dims(m):
    d_inner = m["ssm_expand"] * m["d_model"]
    P = m["ssm_head_dim"]
    return d_inner, d_inner // P, P, m["ssm_state"]


def leaves(m):
    """path -> (shape, init, dtype), as ``moe_transformer.leaves``; init
    also ("A_log",) and ("dt_bias",)."""
    L, D, V, K = m["n_layers"], m["d_model"], m["vocab_size"], m["ssm_conv"]
    di, H, _, N = dims(m)

    def normal(fan_in):
        return ("normal", 1.0 / math.sqrt(fan_in))

    s = "blocks/l0/ssm/"
    return {
        "tok_embed": ((V, D), ("normal", 1.0), "act"),
        "unembed": ((D, V), normal(D), "act"),
        "final_norm": ((D,), ("scale",), "f32"),
        "blocks/l0/ln1": ((L, D), ("scale",), "f32"),
        s + "z_proj": ((L, D, di), normal(D), "act"),
        s + "x_proj": ((L, D, di), normal(D), "act"),
        s + "b_proj": ((L, D, N), normal(D), "act"),
        s + "c_proj": ((L, D, N), normal(D), "act"),
        s + "dt_proj": ((L, D, H), normal(D), "act"),
        s + "conv_x": ((L, K, di), ("normal", 0.5), "act"),
        s + "conv_x_b": ((L, di), ("normal", 0.1), "act"),
        s + "conv_b": ((L, K, N), ("normal", 0.5), "act"),
        s + "conv_b_b": ((L, N), ("normal", 0.1), "act"),
        s + "conv_c": ((L, K, N), ("normal", 0.5), "act"),
        s + "conv_c_b": ((L, N), ("normal", 0.1), "act"),
        s + "A_log": ((L, H), ("A_log",), "f32"),
        s + "D": ((L, H), ("scale",), "f32"),
        s + "dt_bias": ((L, H), ("dt_bias",), "f32"),
        s + "norm": ((L, di), ("scale",), "f32"),
        s + "out_proj": ((L, di, D), normal(di), "act"),
    }


def forward(m, p, ids: torch.Tensor, *, precision: str = "float32",
            cache: bool = False, stats: bool = False):
    """ids [B,S] -> {"logits": [B,V] of the last position, "cache": {"conv":
    [L,B,K-1,d_inner+2N] (the last K-1 steps' x|B|C before the conv),
    "state": [L,B,H,P,N]} with ``cache``, "stats": {}}."""
    q8 = plain.PRECISIONS[precision]
    B, S = ids.shape
    L, eps, K = m["n_layers"], m["norm_eps"], m["ssm_conv"]
    di, H, P, N = dims(m)
    x = q8(p["tok_embed"])[ids]
    convs, states = [], []
    for l in range(L):
        def w(name):
            return p["blocks/l0/ssm/" + name][l]

        h = q8(plain.rmsnorm(x, p["blocks/l0/ln1"][l], eps))
        z, xr, br, cr, dtr = (h @ q8(w(n)) for n in (
            "z_proj", "x_proj", "b_proj", "c_proj", "dt_proj"))
        xs = plain.causal_conv_silu(xr, q8(w("conv_x")), q8(w("conv_x_b")))
        Bs = plain.causal_conv_silu(br, q8(w("conv_b")), q8(w("conv_b_b")))
        Cs = plain.causal_conv_silu(cr, q8(w("conv_c")), q8(w("conv_c_b")))
        dt = F.softplus(dtr + w("dt_bias").float())
        A = -torch.exp(w("A_log").float())
        xh = xs.reshape(B, S, H, P)
        y, state = plain.ssd(xh, dt, A, Bs, Cs, CHUNK)
        y = y + w("D").float()[:, None] * xh
        g = y.reshape(B, S, di) * F.silu(z)
        x = x + q8(plain.rmsnorm(g, w("norm"), eps)) @ q8(w("out_proj"))
        if cache:
            raw = torch.cat([xr, br, cr], dim=-1)
            convs.append(F.pad(raw, (0, 0, max(0, K - 1 - S), 0))
                         [:, -(K - 1):])
            states.append(state)
    last = plain.rmsnorm(x[:, -1], p["final_norm"], eps)
    out = {"logits": q8(last) @ q8(p["unembed"])}
    if cache:
        out["cache"] = {"conv": torch.stack(convs),
                        "state": torch.stack(states)}
    if stats:
        out["stats"] = {}
    return out


def port_cache(kept, S: int):
    """The program's cache of one request, ``{"l0/conv": [L,K-1,C],
    "l0/state": [L,H,P,N]}``, under :func:`forward`'s names."""
    return {"conv": kept["l0/conv"], "state": kept["l0/state"]}


def model_flops(m, B: int, S: int) -> float:
    """A prefill call of B prompts of S tokens: the in-projections (z, x,
    B, C, dt), the causal convolutions, the SSD within chunks (C.B^T, the
    masked products with x, each chunk's state), the state passed across
    chunks and read by C, the out-projection, and the unembed of the last
    position.  2 flops a multiply-add."""
    D = m["d_model"]
    di = m["ssm_expand"] * D
    P, N, K = m["ssm_head_dim"], m["ssm_state"], m["ssm_conv"]
    H = di // P
    T = B * S
    Q = roofline.ssd_chunk_len(S, m["ssm_chunk"])
    nc = S // Q
    inproj = 2 * T * D * (2 * di + 2 * N + H)
    conv = 2 * T * K * (di + 2 * N)
    intra = roofline.ssd_cost(B * nc, Q, H, P, N)[1]
    across = 2 * T * N * H * P + 2 * B * nc * H * P * N
    outproj = 2 * T * di * D
    unembed = 2 * B * D * m["vocab_size"]
    return (m["n_layers"] * (inproj + conv + intra + across + outproj)
            + unembed)
