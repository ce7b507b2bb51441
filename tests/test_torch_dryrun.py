"""The port's dry-run, roofline and report (``repro_torch.launch.dryrun``,
``roofline``, ``report``) on the CPU.

- The dry-run equals a real run: each smoke cell of
  ``tests/torch_dryrun_helpers.py`` (qwen3-1.7b and granite's train,
  prefill and serve steps) at a fake (2, 2) mesh on the meta device counts
  what rank 0 of 4 spawned gloo ranks counts running the same step on real
  CPU tensors: the same aten FLOPs, kernel records and collectives (count
  and bytes by kind and by axis), the peak within 10%.  granite's grouped
  matmuls cover fewer rows on real data than the dry-run's capacity bound
  (``models.moe.moe_gather``): their launches are equal and their rows,
  FLOPs and bytes at most the bound's.
- A kernel's record does not depend on its route: on meta tensors and on
  CPU tensors, forward and backward, the records are the same.
- The cost formulas give ``PERF.md``'s kernel table's bound column.
- ``model_flops_train`` and ``model_flops_decode`` of each architecture's
  active parameters equal ``repro.launch.roofline``'s.
- One production cell a kind at ``pod_16x16`` and full width (granite's
  ``prefill_32k``, qwen3-1.7b's ``decode_32k``, mamba2's ``long_500k``,
  qwen2-1.5b's ``train_4k``) runs on meta, fits, launches the kernels its
  layers need, and decode's all-gathers carry each layer's KV cache.
- The report: the port's cells rendered by the reference's
  ``repro.launch.report`` give the port's tables, apart from the capacity
  in the "fits" header and "run" for "compile".
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun, report  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_dryrun_helpers as H  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
GMM = ("grouped_matmul", "grouped_matmul_dx", "grouped_matmul_dw")


# ------------------------------------------------ the dry-run = a real run
@pytest.fixture(scope="module")
def real_counts(tmp_path_factory):
    """Rank 0's counts of every job, from 4 spawned gloo ranks."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    world = H.MESH[0] * H.MESH[1]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dryrun_helpers.py"),
         str(r), str(world), str(tmp / "store"), str(tmp / "out.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return json.loads((tmp / "out.json").read_text())


@pytest.mark.parametrize("arch,shape", H.JOBS,
                         ids=[f"{a}-{s[0]}" for a, s in H.JOBS])
def test_dryrun_equals_real_run(real_counts, arch, shape):
    cell = dryrun.run_cell(arch, H.shape_spec(shape), mesh_shape=H.MESH,
                           cfg=H.smoke_cfg(arch), verbose=False)
    assert cell["status"] == "ok", cell.get("traceback")
    dry, real = cell["counts"], real_counts[f"{arch}|{shape[0]}"]
    assert dry["aten_flops"] == real["aten_flops"]
    assert dry["collectives"] == real["collectives"]
    assert dry["axis_collectives"] == real["axis_collectives"]
    assert dry["collectives"]                 # the step is sharded
    assert set(dry["kernels"]) == set(real["kernels"])
    for name, rec in dry["kernels"].items():
        got = real["kernels"][name]
        if name in GMM:
            assert got["launches"] == rec["launches"]
            for key in ("rows", "flops", "bytes"):
                assert 0 < got[key] <= rec[key], (name, key)
        else:
            assert got == rec, name
    if not any(n in dry["kernels"] for n in GMM):
        assert dry["flops_by_dtype"] == real["flops_by_dtype"]
    assert abs(dry["peak_bytes"] - real["peak_bytes"]) <= \
        0.1 * real["peak_bytes"]


# --------------------------------------- a kernel's record and its route
def _kernel_calls():
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen).to(dtype)

    offs = torch.tensor([0, 5, 12, 20, 32], dtype=torch.int32)
    return {
        "rmsnorm": (lambda x, w: ops.rmsnorm(x, w),
                    (rnd(12, 64), rnd(64, dtype=torch.float32))),
        "flash_attention": (
            lambda q, k, v: ops.flash_attention(q, k, v, causal=True,
                                                window=5),
            (rnd(2, 16, 4, 16), rnd(2, 16, 2, 16), rnd(2, 16, 2, 16))),
        "grouped_matmul": (lambda x, w: ops.grouped_matmul(x, w, offs),
                           (rnd(32, 24), rnd(4, 24, 40))),
        "ssd_chunk": (lambda x, dt, a, B, C: ops.ssd_chunk(x, dt, a, B, C),
                      (rnd(3, 16, 2, 8, dtype=torch.float32),
                       rnd(3, 16, 2, dtype=torch.float32).abs(),
                       -rnd(3, 16, 2, dtype=torch.float32).abs(),
                       rnd(3, 16, 8, dtype=torch.float32),
                       rnd(3, 16, 8, dtype=torch.float32))),
    }


def _records(fn, args, device, grad):
    args = [a.to(device).requires_grad_(grad) for a in args]
    with rl.Counter() as c:
        out = fn(*args)
        if grad:
            out = out[0] if isinstance(out, tuple) else out
            out.float().sum().backward()
    return c.kernels


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("name", ["rmsnorm", "flash_attention",
                                  "grouped_matmul", "ssd_chunk"])
def test_kernel_record_is_the_same_on_meta_and_cpu(name, grad):
    fn, args = _kernel_calls()[name]
    if grad and name == "ssd_chunk":
        # no backward kernel: under grad the plain version runs and counts
        # as aten ops on either device
        assert _records(fn, args, "meta", True) == {}
        assert _records(fn, args, "cpu", True) == {}
        return
    meta = _records(fn, args, "meta", grad)
    assert meta == _records(fn, args, "cpu", grad)
    want = {name} | ({f"{name}_bwd"} if grad and name != "grouped_matmul"
                     else set()) | ({"grouped_matmul_dx", "grouped_matmul_dw"}
                                    if grad and name == "grouped_matmul"
                                    else set())
    assert set(meta) == want
    assert all(r["launches"] == 1 for r in meta.values())
    assert all(c == 0 for c in ops.LAUNCHES.values())


def test_no_counter_no_record_and_plain_route():
    """With no counter, CPU tensors take the plain version directly (no
    autograd Function), and nothing is recorded."""
    x = torch.randn(4, 8, requires_grad=True)
    y = ops.rmsnorm(x, torch.ones(8))
    assert rl.ACTIVE is None
    assert "RmsNorm" not in type(y.grad_fn).__name__


def test_counter_refuses_a_tensor_off_its_device():
    with pytest.raises(RuntimeError, match="only_device"):
        with rl.Counter(only_device="meta"):
            torch.ones(3)
    assert rl.ACTIVE is None


# --------------------------------------------- formulas and PERF.md bounds
# PERF.md's kernel table: (kernel, formula arguments, dtype, bound ms as
# the table prints it, what bounds it)
PERF_BOUNDS = [
    ("rmsnorm", (4096, 1024), "bfloat16", "0.005009", "bytes"),
    ("rmsnorm", (8, 1024), "bfloat16", "1.1e-05", "bytes"),
    ("rmsnorm", (4096, 1536), "bfloat16", "0.007514", "bytes"),
    ("rmsnorm", (4096, 3072), "bfloat16", "0.01503", "bytes"),
    ("rmsnorm", (8, 3072), "bfloat16", "3.301e-05", "bytes"),
    ("attention", (8, 512, 512, 16, 8, 64, True, 0), "bfloat16", "0.007512",
     "bytes"),
    ("attention", (8, 1500, 1500, 16, 16, 64, False, 0), "bfloat16",
     "0.07455", "operations"),
    ("attention", (8, 224, 1500, 16, 16, 64, False, 0), "bfloat16",
     "0.01686", "bytes"),
    ("attention", (8, 1, 1500, 16, 16, 64, False, 0), "bfloat16", "0.01468",
     "bytes"),
    ("attention", (8, 768, 768, 32, 32, 96, True, 0), "bfloat16", "0.04507",
     "bytes"),
    ("attention", (1, 8192, 8192, 64, 8, 128, True, 4096), "bfloat16",
     "0.8339", "operations"),
    ("gmm", (32768, 1024, 512, 32, 32768, 32), "bfloat16", "0.04007",
     "bytes"),
    ("gmm", (32768, 512, 1024, 32, 32768, 32), "bfloat16", "0.04007",
     "bytes"),
    ("gmm", (64, 1024, 512, 32, 64, 28), "bfloat16", "0.008823", "bytes"),
    ("gmm", (64, 512, 1024, 32, 64, 26), "bfloat16", "0.008197", "bytes"),
    ("gmm", (40960, 1024, 512, 32, 32768, 32), "bfloat16", "0.04257",
     "bytes"),
    ("gmm", (40960, 512, 1024, 32, 32768, 32), "bfloat16", "0.04507",
     "bytes"),
    ("gmm", (256, 1024, 512, 32, 64, 26), "bfloat16", "0.008256", "bytes"),
    ("gmm", (256, 512, 1024, 32, 64, 26), "bfloat16", "0.008314", "bytes"),
    ("ssd", (16, 256, 48, 64, 128), "float32", "0.09835", "operations"),
    ("rmsnorm_bwd", (4096, 1024), "bfloat16", "0.007515", "bytes"),
    ("rmsnorm_bwd", (4096, 2048), "bfloat16", "0.01503", "bytes"),
    ("rmsnorm_bwd", (4096, 1536), "bfloat16", "0.01127", "bytes"),
    ("rmsnorm_bwd", (65536, 128), "bfloat16", "0.01502", "bytes"),
    ("rmsnorm_bwd", (37, 1001), "bfloat16", "6.873e-05", "bytes"),
    ("rmsnorm_bwd", (5, 64), "bfloat16", "7.26e-07", "bytes"),
    ("attention_bwd", (8, 512, 512, 16, 8, 64, True, 0), "bfloat16",
     "0.0151", "bytes"),
    ("attention_bwd", (8, 512, 512, 16, 8, 128, True, 0), "bfloat16",
     "0.03013", "bytes"),
    ("attention_bwd", (8, 768, 768, 32, 32, 96, True, 0), "bfloat16",
     "0.09038", "bytes"),
    # dX = dY W^T: lhs dY [T, F], N = D
    ("gmm", (32768, 512, 1024, 32, 32768, 32), "bfloat16", "0.04007",
     "bytes"),
    ("gmm", (32768, 1024, 512, 32, 32768, 32), "bfloat16", "0.04007",
     "bytes"),
    ("gmm_dw", (1024, 512, 32, 32768), "bfloat16", "0.04007", "bytes"),
    ("gmm_dw", (512, 1024, 32, 32768), "bfloat16", "0.04007", "bytes"),
]
FORMULAS = {"rmsnorm": rl.rmsnorm_cost, "rmsnorm_bwd": rl.rmsnorm_bwd_cost,
            "attention": rl.attention_cost,
            "attention_bwd": rl.attention_bwd_cost, "gmm": rl.gmm_cost,
            "gmm_dw": rl.gmm_dw_cost, "ssd": rl.ssd_cost}


@pytest.mark.parametrize("kernel,args,dtype,want,by", PERF_BOUNDS,
                         ids=[f"{k}-{'x'.join(map(str, a))}"
                              for k, a, *_ in PERF_BOUNDS])
def test_formulas_give_the_perf_table_bounds(kernel, args, dtype, want, by):
    es = {"bfloat16": 2, "float32": 4}[dtype]
    cost = FORMULAS[kernel](*args, *(() if kernel == "ssd" else (es,)))
    ms, got_by = rl.bound_ms(*cost, dtype)
    assert (f"{ms:.4g}", got_by) == (want, by)


def test_attention_pairs_count_the_band():
    for Sq, w in ((1, 0), (7, 0), (7, 3), (7, 7), (7, 9), (100, 33)):
        mask = [min(i + 1, w or Sq) for i in range(Sq)]
        assert rl.attention_pairs(Sq, Sq, True, w) == sum(mask)
    assert rl.attention_pairs(5, 9, False, 0) == 45


# ---------------------------------------------------- model FLOPs parity
@pytest.mark.parametrize("arch", configs.list_archs(),
                         ids=lambda a: a.replace(".", "_"))
def test_model_flops_match_the_reference(arch):
    from repro import configs as jconfigs
    n = configs.active_param_count(configs.get_config(arch))
    assert n == jconfigs.active_param_count(jconfigs.get_config(arch))
    for tokens in (1, 128, 256 * 4096):
        assert rl.model_flops_train(n, tokens) == \
            jroofline.model_flops_train(n, tokens)
        assert rl.model_flops_decode(n, tokens) == \
            jroofline.model_flops_decode(n, tokens)


# ---------------------------------------------------- production cells
PROD = [("granite-moe-1b-a400m", "prefill_32k"), ("qwen3-1.7b", "decode_32k"),
        ("mamba2-780m", "long_500k"), ("qwen2-1.5b", "train_4k")]


@pytest.fixture(scope="module")
def prod_cells():
    """The production cells, and a skipped one, at pod_16x16."""
    cells = {(a, s): dryrun.run_cell(a, s, verbose=False) for a, s in PROD}
    cells[("qwen3-1.7b", "long_500k")] = dryrun.run_cell(
        "qwen3-1.7b", "long_500k", verbose=False)
    return cells


def _want_kernels(cfg, kind):
    """The kernels a cell of ``kind`` must launch, from its layers."""
    attn = any(k == "attn" for k in cfg.pattern)
    want = {"rmsnorm"}
    if attn and kind != "decode":
        want.add("flash_attention")
    if cfg.n_experts > 0:
        want.add("grouped_matmul")
    if kind == "prefill" and any(k != "attn" for k in cfg.pattern):
        want.add("ssd_chunk")
    if kind == "train":
        want |= {"rmsnorm_bwd"} | ({"flash_attention_bwd"} if attn else set())
    return want


@pytest.mark.parametrize("arch,shape", PROD, ids=[f"{a}-{s}" for a, s in PROD])
def test_production_cell(prod_cells, arch, shape):
    cell = prod_cells[(arch, shape)]
    assert cell["status"] == "ok", cell.get("traceback")
    spec, cfg = SHAPES[shape], dryrun.cell_config(arch, SHAPES[shape])
    assert cell["n_devices"] == 256 and cell["mesh"] == "pod_16x16"
    assert cell["fits_hbm"] and 0 < cell["memory"]["peak_bytes"] < \
        rl.HBM_BYTES
    counts, r = cell["counts"], cell["roofline"]
    assert set(counts["kernels"]) == _want_kernels(cfg, spec.kind)
    assert counts["kernels"]["rmsnorm"]["launches"] >= cfg.n_layers
    assert r["flops_per_device"] > 0 and r["bottleneck"] in (
        "compute", "memory", "collective")
    assert cell["model_flops_per_device"] == pytest.approx(
        dryrun.model_flops(cfg, spec) / 256)
    by_axis = counts["axis_collectives"]
    if spec.kind == "decode" and cfg.n_kv_heads:
        # each attention layer gathers its KV cache over model: at least
        # the cache's K and V, whole over model, for this rank's rows
        b = spec.global_batch // 16 if spec.global_batch >= 16 else 1
        s_max = spec.seq_len + 128
        cache = 2 * b * s_max * cfg.n_kv_heads * cfg.d_head * 2
        n_attn = sum(1 for k in cfg.pattern if k == "attn") * cfg.n_blocks
        assert by_axis["model"]["all-gather"]["bytes"] >= n_attn * cache
    if spec.kind == "train":
        assert "reduce-scatter" in counts["collectives"]


def test_skipped_cell(prod_cells):
    cell = prod_cells[("qwen3-1.7b", "long_500k")]
    assert cell["status"] == "skipped" and "full-attention" in cell["reason"]


# ---------------------------------------------------------------- report
def _reference_report():
    """``repro.launch.report``, whose import (through the reference's
    dry-run) sets a 512-device XLA_FLAGS; restored at once, before jax
    starts its backend."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import report as jreport
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jreport


def test_report_matches_the_reference(prod_cells, tmp_path):
    cells = list(prod_cells.values())
    for i, c in enumerate(cells):
        (tmp_path / f"{i}.json").write_text(json.dumps(c))
    cells = report.load_cells(tmp_path)
    jreport = _reference_report()
    as_ref = [{**c, "compile_s": c["run_s"]} if c["status"] == "ok" else c
              for c in cells]
    ours = report.roofline_table(cells)
    theirs = jreport.roofline_table(as_ref)
    assert ours.replace(f"fits {report.CAPACITY}", "fits 16G") == theirs
    assert f"fits {rl.HBM_BYTES / 2**30:.1f}G" in ours
    assert report.dryrun_table(cells).replace("| run |", "| compile |") == \
        jreport.dryrun_table(as_ref)
    assert report.summary(cells) == jreport.summary(as_ref) == {
        "ok": 4, "skipped": 1, "error": 0, "fits": 4, "total": 5}
