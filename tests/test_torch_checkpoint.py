"""The port's checkpoints against ``repro.checkpoint``, on the CPU.

The reference's ``TestCheckpoint`` cases on port trees; both packages
writing the same bytes for the same tree (manifest and every ``.npy``);
each package loading what the other saved, bit for bit; the async
snapshot being a copy; and the error types.  The trees hold f32 and bf16
leaves, an int32 step count and Python ints (the data state), as the
Trainer's do.
"""
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint import checkpoint as ckpt_mod  # noqa: E402
from repro_torch.weights import (flatten, from_jax_opt_state,  # noqa: E402
                                 from_jax_params)


def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32)}}


def _same_bits(a, b):
    """Two torch tensors: same dtype, shape and bits."""
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32}[a.element_size()]
        a, b = a.view(view), b.view(view)
    assert torch.equal(a, b)


# ------------------------------------------------ the reference's cases
class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        t = _tree()
        save_checkpoint(tmp_path, 7, t)
        assert latest_step(tmp_path) == 7
        out = load_checkpoint(tmp_path, 7, t)
        _same_bits(out["a"], t["a"])
        _same_bits(out["b"]["c"], t["b"]["c"])

    def test_gc_keeps_latest(self, tmp_path):
        t = _tree()
        for s in (1, 2, 3, 4, 5):
            save_checkpoint(tmp_path, s, t, keep=2)
        assert latest_step(tmp_path) == 5
        steps = sorted(int(p.name.split("_")[1])
                       for p in tmp_path.glob("step_*"))
        assert steps == [4, 5]

    def test_corruption_detected(self, tmp_path):
        t = _tree()
        d = save_checkpoint(tmp_path, 1, t)
        f = next(d.glob("leaf_*.npy"))
        data = bytearray(f.read_bytes())
        data[-1] ^= 0xFF
        f.write_bytes(bytes(data))
        with pytest.raises(IOError, match="crc"):
            load_checkpoint(tmp_path, 1, t)
        load_checkpoint(tmp_path, 1, t, verify=False)   # unchecked: loads

    def test_uncommitted_ignored(self, tmp_path):
        t = _tree()
        d = save_checkpoint(tmp_path, 3, t)
        (d / "_COMMITTED").unlink()
        assert latest_step(tmp_path) is None
        with pytest.raises(FileNotFoundError):
            load_checkpoint(tmp_path, 3, t)

    def test_async_manager(self, tmp_path):
        m = CheckpointManager(tmp_path)
        t = _tree()
        m.async_save(1, t)
        m.wait()
        step, out = m.restore_latest(t)
        assert step == 1
        _same_bits(out["a"], t["a"])
        assert CheckpointManager(tmp_path / "none").restore_latest(t) == (
            None, None)


def test_tmp_directory_is_never_a_committed_step(tmp_path):
    """A crash between ``_COMMITTED`` and the rename leaves a ``.tmp``
    directory holding the marker: it is no step, and GC leaves it."""
    t = _tree()
    save_checkpoint(tmp_path, 2, t)
    tmp = tmp_path / "step_000000005.tmp"
    tmp.mkdir()
    (tmp / "_COMMITTED").write_text("ok")
    assert latest_step(tmp_path) == 2
    save_checkpoint(tmp_path, 3, t, keep=1)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_000000003", "step_000000005.tmp"]


def test_load_errors(tmp_path):
    """A leaf missing from the step raises KeyError, a shape that differs
    ValueError; a leaf of the step that the tree does not ask for is
    left alone."""
    t = _tree()
    save_checkpoint(tmp_path, 1, t)
    with pytest.raises(KeyError, match="missing leaf x"):
        load_checkpoint(tmp_path, 1, {**t, "x": torch.zeros(2)})
    with pytest.raises(ValueError, match="a: checkpoint shape"):
        load_checkpoint(tmp_path, 1, {**t, "a": torch.zeros(4, 3)})
    out = load_checkpoint(tmp_path, 1, {"a": t["a"]})
    assert list(out) == ["a"]


def test_leaves_take_the_dtype_and_device_of_tree_like(tmp_path):
    """bf16 bits, a 0-d int32 count and a Python int come back as they
    were; a leaf is cast to the dtype of ``tree_like``'s leaf."""
    gen = torch.Generator().manual_seed(0)
    t = {"w": torch.randn(4, 6, generator=gen).to(torch.bfloat16),
         "count": torch.tensor(7, dtype=torch.int32),
         "data": {"step": 12, "seed": 3},
         "f": torch.randn(3, generator=gen)}
    save_checkpoint(tmp_path, 12, t)
    out = load_checkpoint(tmp_path, 12, t)
    _same_bits(out["w"], t["w"])
    _same_bits(out["count"], t["count"])
    assert out["count"].shape == () and out["data"] == {"step": 12,
                                                         "seed": 3}
    assert type(out["data"]["step"]) is int
    wide = load_checkpoint(tmp_path, 12, {**t, "w": t["w"].float()},
                           device="cpu")
    _same_bits(wide["w"], t["w"].float())


def test_async_error_raised_by_wait(tmp_path):
    """An error in the writer thread is raised again by ``wait()``, and
    only once."""
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    m = CheckpointManager(blocker)
    m.async_save(1, _tree())
    with pytest.raises(OSError):
        m.wait()
    m.wait()


def test_async_snapshot_is_a_copy(tmp_path, monkeypatch):
    """``async_save`` copies the tree before it returns: an in-place change
    made after it (here, while the writer is held back) never reaches the
    disk, even for CPU tensors, whose ``.cpu()`` shares storage."""
    go = threading.Event()
    write = ckpt_mod._write

    def held(*args):
        assert go.wait(timeout=60)
        return write(*args)

    monkeypatch.setattr(ckpt_mod, "_write", held)
    t = _tree()
    want = {"a": t["a"].clone(), "b": {"c": t["b"]["c"].clone()}}
    m = CheckpointManager(tmp_path)
    m.async_save(1, t)
    t["a"].add_(100.0)
    t["b"]["c"].mul_(-1)
    go.set()
    m.wait()
    out = load_checkpoint(tmp_path, 1, t)
    _same_bits(out["a"], want["a"])
    _same_bits(out["b"]["c"], want["b"]["c"])


# --------------------------------------------- across the two packages
def _mixed():
    """(JAX tree, port tree) of the same values: f32, bf16, an int32 count
    and Python ints."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    h = rng.standard_normal((2, 5)).astype(np.float32)
    jtree = {"w": jnp.asarray(w), "h": jnp.asarray(h, jnp.bfloat16),
             "opt": {"count": jnp.asarray(3, jnp.int32)},
             "data": {"step": 7, "seed": 3, "batch_size": 8}}
    hb = np.asarray(jtree["h"]).view(np.uint16).astype(np.int16)
    ttree = {"w": torch.from_numpy(w),
             "h": torch.from_numpy(hb).view(torch.bfloat16),
             "opt": {"count": torch.tensor(3, dtype=torch.int32)},
             "data": {"step": 7, "seed": 3, "batch_size": 8}}
    return jtree, ttree


def _trainer_state():
    """(JAX tree, port tree): the reference Trainer's checkpoint tree for
    the granite smoke model with bf16 working params, one AdamW update
    in, carried into the port with the weights loaders."""
    jcfg = jconfigs.get_smoke_config("granite-moe-1b-a400m")
    jp, _ = japi.init(jcfg.replace(param_dtype=jcfg.dtype),
                      jax.random.PRNGKey(0))
    opt = joptim.with_master(joptim.adamw(
        joptim.cosine_with_warmup(1e-3, 1, 10)))
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.01), jp)
    jp, state = opt.update(grads, opt.init(jp), jp)
    data = {"step": 1, "seed": 0, "batch_size": 2}
    np_p = jax.tree.map(np.asarray, jp)
    return ({"params": jp, "opt": state, "data": dict(data)},
            {"params": from_jax_params(np_p, keep_bf16=True),
             "opt": from_jax_opt_state(jax.tree.map(np.asarray, state)),
             "data": dict(data)})


TREES = {"mixed": _mixed, "trainer_state": _trainer_state}


@pytest.mark.parametrize("name", list(TREES))
def test_both_packages_write_the_same_bytes(tmp_path, name):
    """The same tree saved by ``repro.checkpoint`` and by the port: the
    same files, ``manifest.json`` equal as JSON, every ``.npy`` byte for
    byte."""
    jtree, ttree = TREES[name]()
    jd = jckpt.save_checkpoint(tmp_path / "jax", 5, jtree)
    td = save_checkpoint(tmp_path / "port", 5, ttree)
    assert sorted(p.name for p in jd.iterdir()) == sorted(
        p.name for p in td.iterdir())
    jm = json.loads((jd / "manifest.json").read_text())
    assert jm == json.loads((td / "manifest.json").read_text())
    assert {m["dtype"] for m in jm["leaves"].values()} >= {
        "bfloat16", "int32", "int64"}
    for f in jd.glob("leaf_*.npy"):
        assert f.read_bytes() == (td / f.name).read_bytes(), f.name
    # the async writer writes the same bytes
    mgr = CheckpointManager(tmp_path / "async")
    mgr.async_save(5, ttree)
    mgr.wait()
    for f in jd.glob("*"):
        assert f.read_bytes() == (tmp_path / "async" / jd.name /
                                  f.name).read_bytes(), f.name


@pytest.mark.parametrize("name", list(TREES))
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_each_package_reads_the_other(tmp_path, name, direction):
    """A step saved by one package loads in the other with the same bits:
    bf16 as bf16, the int32 count as a 0-d int32, Python ints as ints."""
    jtree, ttree = TREES[name]()
    if direction == "jax_to_port":
        jckpt.save_checkpoint(tmp_path, 9, jtree)
        like = {**ttree, "data": {k: 0 for k in ttree["data"]}}
        out = load_checkpoint(tmp_path, 9, like)
        for path, want in flatten(ttree).items():
            got = flatten(out)[path]
            if torch.is_tensor(want):
                _same_bits(got, want)
            else:
                assert type(got) is int and got == want
    else:
        save_checkpoint(tmp_path, 9, ttree)
        like = {**jtree, "data": {k: 0 for k in jtree["data"]}}
        out = jckpt.load_checkpoint(tmp_path, 9, like)
        got, want = flatten(jax.tree.map(np.asarray, out)), flatten(
            jax.tree.map(np.asarray, jtree))
        for path, w in want.items():
            g = got[path]
            assert g.dtype == w.dtype and g.shape == w.shape, path
            assert g.tobytes() == w.tobytes(), path


# ------------------------------------------------------ on the card only
@pytest.mark.cuda
def test_cuda_save_and_load_same_bits(tmp_path):
    """Save CUDA tensors (bf16, f32, an int32 count), load them back onto
    the card: the same bits, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100: "
                    "python3 chip_smoke.py checks the same at full size)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t = {"p": torch.randn(64, 33, generator=gen, device="cuda").to(
        torch.bfloat16),
        "m": torch.randn(1000, generator=gen, device="cuda"),
        "count": torch.tensor(4, dtype=torch.int32, device="cuda"),
        "data": {"step": 4}}
    save_checkpoint(tmp_path, 4, t)
    out = load_checkpoint(tmp_path, 4, t)
    for k in ("p", "m", "count"):
        assert out[k].is_cuda
        _same_bits(out[k], t[k])
    assert out["data"] == {"step": 4}
