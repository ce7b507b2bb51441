"""``correct`` against planted faults and the float8 control, on the CPU.

Each fault breaks the timed path underneath a whole run (the chip's look
skipped): the judgement has to come out false.  A serving cell on one
chip can have three of the four faults; it has no exchange between
chips to leave out.  Each is planted in the whole batch and in one slot
of eight."""
import pytest
import torch

from portbench import bench, check, control
from portbench.tests.helpers import (CELLS, SEED, SMALL_TRAFFIC, run_small,
                                     small)

# the slot whose cache the second cached call keeps: a fault there shows
# only if the kept caches turn over the slots
SLOT = check.kept_rows(check.CACHE_EVERY, 8, SEED)[0]


class StateUnchanged(bench.Program):
    """prefill hands back its caches as they were before it: empty."""

    def prefill(self, ids, s_max):
        logits, caches = super().prefill(ids, s_max)
        return logits, {name: type(c)(*[torch.zeros_like(t) if isinstance(
            t, torch.Tensor) else t for t in c]) for name, c in caches.items()}


class HalfBatch(bench.Program):
    """Half of the batch left out: its rows get the other half's outputs."""

    def prefill(self, ids, s_max):
        h = ids.shape[0] // 2
        logits, caches = super().prefill(ids[:h], s_max)
        twice = {name: type(c)(*[torch.cat([t, t], 1) if isinstance(
            t, torch.Tensor) else t for t in c]) for name, c in caches.items()}
        return torch.cat([logits, logits]), twice


class TokenAltered(bench.Program):
    """The first token altered where it is produced."""

    def first_tokens(self, logits):
        return (super().first_tokens(logits) + 1) % logits.shape[-1]


def _other_slot(t, dim):
    """``t`` with slot ``SLOT``'s entry along ``dim`` replaced by the next
    slot's."""
    t = t.clone()
    t.select(dim, SLOT).copy_(t.select(dim, (SLOT + 1) % t.shape[dim]))
    return t


class SlotState(bench.Program):
    """One slot's cache is another request's."""

    def prefill(self, ids, s_max):
        logits, caches = super().prefill(ids, s_max)
        return logits, {name: type(c)(*[_other_slot(t, 1) if isinstance(
            t, torch.Tensor) else t for t in c]) for name, c in caches.items()}


class SlotLogits(bench.Program):
    """One slot's logits (and so its token) are another request's."""

    def prefill(self, ids, s_max):
        logits, caches = super().prefill(ids, s_max)
        return _other_slot(logits, 0), caches


class SlotToken(bench.Program):
    """One slot's first token altered where it is produced."""

    def first_tokens(self, logits):
        t = super().first_tokens(logits)
        t[SLOT] = (t[SLOT] + 1) % logits.shape[-1]
        return t


FAULTS = [StateUnchanged, HalfBatch, TokenAltered]
SLOT_FAULTS = [SlotState, SlotLogits, SlotToken]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(cell):
    assert run_small(cell)["correct"] is True


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_planted_fault_is_not_correct(cell, fault):
    out = run_small(cell, program_cls=fault)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_the_kept_caches_turn_over_every_slot():
    for batch in (1, 4, 8):
        rows = {check.kept_rows(check.CACHE_EVERY * k, batch, SEED)[0]
                for k in range(batch)}
        assert rows == set(range(batch))
    assert SLOT != check.kept_rows(0, 8, SEED)[0]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_of_eight_slots_is_correct(cell):
    out = run_small(cell, seconds=1.0,
                    traffic_over={**SMALL_TRAFFIC, "batch": 8})
    assert out["attempted"] > 8 * check.CACHE_EVERY
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("fault", SLOT_FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_fault_in_one_slot_of_eight_is_not_correct(cell, fault):
    out = run_small(cell, seconds=1.0, program_cls=fault,
                    traffic_over={**SMALL_TRAFFIC, "batch": 8})
    assert out["attempted"] > 8 * check.CACHE_EVERY
    assert out["correct"] is False, out["checks"]


# the depth of the cell's model at the test's widths: the errors of the
# program and of the control grow with depth as at full size
DEEP = {"granite-moe-1b-a400m.prefill": dict(n_layers=24, n_experts=32,
                                             top_k=8),
        "mamba2-780m.prefill": dict(n_layers=48)}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_fp8_control_fails_a_limit_that_the_program_meets(cell):
    from portbench import manifest
    limits = manifest.cell(cell).limits["limits"]
    cfg, model = small(cell, **DEEP[cell])
    kw = dict(device="cpu", port_cfg=cfg, model=model,
              traffic_over=SMALL_TRAFFIC, calls=9)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        prog = control.readings(cell, seed, **kw)
        ctl = control.readings(cell, seed, "fp8", **kw)
        assert all(prog[k] <= v for k, v in limits.items()), prog
        assert any(ctl[k] > v for k, v in limits.items()), ctl
