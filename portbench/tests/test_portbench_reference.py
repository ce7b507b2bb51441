"""The plain references against the program's CPU path at test sizes.

In float32 the program's CPU path (the kernels' plain versions) and the
reference compute the same function in another order: they agree to
rounding.  The float8 control lies far from both."""
import pytest
import torch

from portbench import weights
from portbench.reference import mamba2, moe_transformer, plain
from portbench.tests.helpers import small

FAMILIES = {"granite-moe-1b-a400m.prefill": moe_transformer,
            "mamba2-780m.prefill": mamba2}


def _run(cell, dtype, S=40, B=3, seed=5):
    fam = FAMILIES[cell]
    cfg, m = small(cell, dtype=dtype)
    flat = weights.draw(fam.leaves(m), seed, getattr(torch, dtype), "cpu")
    from repro_torch.models.api import CausalLM
    model = CausalLM(cfg, weights.tree(flat))
    ids = torch.randint(0, m["vocab_size"], (B, S),
                        generator=torch.Generator().manual_seed(seed))
    logits, caches = model.prefill(ids, S + 4)
    ref = fam.forward(m, flat, ids, cache=True)
    return fam, m, flat, ids, logits, caches, ref


def _rel(a, b):
    return float((a.float() - b).norm() / b.norm())


@pytest.mark.parametrize("cell", sorted(FAMILIES))
def test_reference_matches_program_in_f32(cell):
    fam, m, flat, ids, logits, caches, ref = _run(cell, "float32")
    assert _rel(logits, ref["logits"]) < 1e-5
    for row in range(ids.shape[0]):
        kept = {f"{name}/{f}": t[:, row] for name, c in caches.items()
                for f, t in c._asdict().items() if isinstance(t, torch.Tensor)}
        mine = fam.port_cache(kept, ids.shape[1])
        assert set(mine) == set(ref["cache"])
        for leaf, t in mine.items():
            assert _rel(t, ref["cache"][leaf][:, row]) < 1e-5, leaf


@pytest.mark.parametrize("cell", sorted(FAMILIES))
def test_fp8_control_departs_from_the_reference(cell):
    fam, m, flat, ids, _, _, ref = _run(cell, "float32")
    ctl = fam.forward(m, flat, ids, precision="fp8")
    assert _rel(ctl["logits"], ref["logits"]) > 0.03


def test_fp8_rounds_to_three_mantissa_bits():
    t = torch.tensor([448.0, 1.0, 1.0625, -3.3, 0.0])
    q = plain.fp8(t)
    assert q[0] == 448.0 and q[1] == 1.0 and q[4] == 0.0
    assert float(q[2]) in (1.0, 1.125)
    assert abs(float(q[3]) + 3.3) <= 3.3 / 16


def test_ssd_chunking_does_not_change_the_scan():
    g = torch.Generator().manual_seed(0)
    b, S, H, P, N = 2, 37, 3, 4, 5
    x = torch.randn(b, S, H, P, generator=g)
    dt = torch.rand(b, S, H, generator=g) * 0.5
    A = -torch.rand(H, generator=g) * 2
    B = torch.randn(b, S, N, generator=g)
    C = torch.randn(b, S, N, generator=g)
    # the recurrence step by step
    st = torch.zeros(b, H, P, N)
    ys = []
    for t in range(S):
        st = torch.exp(A * dt[:, t])[..., None, None] * st + (
            dt[:, t, :, None, None] * x[:, t, :, :, None]
            * B[:, t, None, None, :])
        ys.append(torch.einsum("bn,bhpn->bhp", C[:, t], st))
    y_ref = torch.stack(ys, 1)
    for chunk in (1, 4, 16, 64):
        y, state = plain.ssd(x, dt, A, B, C, chunk)
        assert torch.allclose(y, y_ref, atol=1e-4, rtol=1e-4), chunk
        assert torch.allclose(state, st, atol=1e-4, rtol=1e-4), chunk


def test_moe_keep_rule_drops_past_capacity():
    cell = "granite-moe-1b-a400m.prefill"
    _, m = small(cell, dtype="float32")
    m = dict(m, capacity_factor=0.25)
    flat = weights.draw(moe_transformer.leaves(m), 3, torch.float32, "cpu")
    ids = torch.randint(0, m["vocab_size"], (2, 64))
    out = moe_transformer.forward(m, flat, ids, stats=True)
    cap = moe_transformer.capacity(m, 64)
    for kept in out["stats"]["moe_kept"]:
        assert kept <= 2 * m["n_experts"] * cap
        assert kept < 2 * 64 * m["top_k"]
