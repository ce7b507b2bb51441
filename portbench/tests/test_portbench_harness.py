"""The harness on the CPU: files found by name, the result line, what
the window and the trace read."""
import json
import shutil
import subprocess
import sys

import pytest

from portbench import manifest, trace
from portbench.bench import Run
from portbench.tests.helpers import CELLS, ROOT, run_small
from portbench.window import Call, Window, percentile

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _copy_root(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for sub in ("configs", "traffic", "workloads", "metrics", "generators"):
        shutil.copytree(ROOT / "portbench" / sub, tmp_path / "portbench" / sub)
    return tmp_path


SPACED = """from portbench.generators.closed_loop import Traffic as Closed


class Traffic(Closed):
    def arrivals(self, i):
        return [0.05 * i] * self.batch
"""


def test_new_cell_metric_and_generator_are_found_without_an_edit(tmp_path):
    root = _copy_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "granite-moe-1b-a400m.short", "config": "granite-moe-1b-a400m",
        "traffic": "short_mix", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({
        "name": "calls.prefill", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "host dispatch",
        "moves": "prefill_tok_s",
        "workloads": ["granite-moe-1b-a400m.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "portbench" / "traffic" / "short_mix.json").write_text(json.dumps(
        {"generator": "spaced", "batch": 2, "prompt_len": 32}))
    (root / "portbench" / "generators" / "spaced.py").write_text(SPACED)
    shutil.copy(root / "portbench" / "workloads"
                / "granite-moe-1b-a400m.prefill.json",
                root / "portbench" / "workloads"
                / "granite-moe-1b-a400m.short.json")
    (root / "portbench" / "metrics" / "calls.prefill.py").write_text(
        "def read(run):\n    return len(run.window.calls)\n")
    cell = manifest.cell("granite-moe-1b-a400m.short", root)
    assert cell.traffic["batch"] == 2
    assert [m.name for m in cell.per_layer] == ["calls.prefill"]
    out = run_small("granite-moe-1b-a400m.prefill", root=root,
                    traffic_over={"prompt_len": 32})
    assert "calls.prefill" not in out["metrics"]
    out = run_small("granite-moe-1b-a400m.short", root=root, traced=True,
                    traffic_over={})
    calls = out["metrics"]["calls.prefill"]["value"]
    assert calls >= 5 and out["attempted"] == 2 * calls
    # calls arrive 0.05 s apart: a 0.3 s window and the traced calls
    assert calls <= 0.3 / 0.05 + 5 + 1


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_result_line_keys(cell):
    out = run_small(cell)
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"prefill_tok_s", "ttft_p90_ms", "setup_s"}
    for m in out["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(out["checks"]) == set(manifest.cell(cell).limits["limits"])
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    assert out["device"]["count"] == 1 and out["attempted"] > 0
    assert out["device"]["platform"] == "cpu"   # never reported as a card


def test_traced_run_has_breakdown_and_no_device_numbers_on_cpu():
    out = run_small("mamba2-780m.prefill", traced=True)
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # no kernel ran on a device: no share, no count is made up
    assert out["metrics"] == {}


def test_cli_without_a_card_exits_nonzero_and_prints_no_result():
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "granite-moe-1b-a400m.prefill", "--seed",
                        str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 3
    assert r.stdout.strip() == ""
    assert "no CUDA device" in r.stderr


def test_cli_outside_a_full_checkout_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "granite-moe-1b-a400m.prefill", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert r.returncode != 0 and r.stdout.strip() == ""


def _run(calls):
    w = Window([Call(i, a, b, 8, 8 * 2048) for i, (a, b) in enumerate(calls)])
    return Run(model={}, setup_s=1.0, window=w)


def test_rate_and_tail_both_move_with_a_stall():
    readers = {n: manifest.Metric(n, "", None, ROOT / "portbench"
                                  / "metrics" / f"{n}.py").reader()
               for n in ("prefill_tok_s", "ttft_p90_ms")}
    steady = [(0.25 * i, 0.25 * i + 0.2) for i in range(40)]
    stalled = list(steady)
    for i in range(30, 40):                       # the last ten stall 0.5 s
        a = stalled[i - 1][1] + 0.05
        stalled[i] = (a, a + 0.7)
    rs, rt = (readers["prefill_tok_s"].read(_run(steady)),
              readers["ttft_p90_ms"].read(_run(steady)))
    ss, st = (readers["prefill_tok_s"].read(_run(stalled)),
              readers["ttft_p90_ms"].read(_run(stalled)))
    assert rs == pytest.approx(40 * 8 * 2048 / (0.25 * 39 + 0.2))
    assert rt == pytest.approx(200.0)
    assert ss < 0.7 * rs and st == pytest.approx(700.0)


def test_percentile_is_linear_between_ranks():
    assert percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], 90) == 10.0
    assert percentile([0.0, 10.0], 90) == pytest.approx(9.0)


def test_idle_is_the_union_of_overlapping_device_intervals():
    E = trace.Ev
    evs = [E("user_annotation", trace.CALL_RANGE, 0, 1000),
           E("kernel", "void (anonymous namespace)::gmm_kernel<1>(int)", 100,
             400),
           E("kernel", "flash_wgmma_kernel(x)", 300, 500),   # overlaps
           E("gpu_memcpy", "Memcpy DtoH", 450, 600),          # overlaps
           E("kernel", "ssd_chunk_kernel", 800, 900),
           E("kernel", "outside", 1200, 1300),
           E("cuda_runtime", "cudaStreamSynchronize", 600, 800),
           E("cuda_runtime", "cudaLaunchKernel", 50, 60)]
    s = trace.summarize(evs)
    assert s.window_s == pytest.approx(1e-6)
    assert s.busy_s == pytest.approx(600e-9)          # 100..600, 800..900
    assert s.idle_s == pytest.approx(400e-9)
    assert s.kernels == 3 and s.syncs == 1 and s.calls == 1
    assert s.device_time("gmm") == (pytest.approx(300e-9), 1)
    gaps = dict(s.idle_gaps)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(200e-9)
    assert gaps["cudaLaunchKernel"] == pytest.approx(10e-9)
    assert sum(gaps.values()) == pytest.approx(400e-9)
    assert trace.union([(5, 9), (0, 3), (2, 4), (9, 10)]) == [(0, 4), (5, 10)]
    assert trace.kernel_key("(anonymous namespace)::ssd_chunk_kernel("
                            "(anonymous namespace)::Args)") == \
        "ssd_chunk_kernel"


def test_ttft_counts_from_each_requests_arrival():
    c = Call(0, 1.0, 1.5, 2, 64, arrived=[0.2, 0.9])
    w = Window([c], opened=0.0)
    assert w.ttfts() == [pytest.approx(1.3), pytest.approx(0.6)]
    assert w.seconds == 1.5
    assert Window([Call(0, 1.0, 1.5, 2, 64)]).ttfts() == [0.5, 0.5]
