"""The harness: BENCHMARK.json against the contract's shape, every name
resolved to its file, a cell added by new files alone, CPU rehearsals of a
run, and the import check."""
import ast
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "perfbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    return harness.load_bench(ROOT)


def one_line(s, limit=200):
    return isinstance(s, str) and 1 <= len(s) <= limit and "\n" not in s and "\t" not in s


def test_benchmark_json_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"] and b["command"] == ["python3", "perfbench/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in b["workloads"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert NAME.match(w["traffic"]) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and UNIT.match(m["unit"]) and one_line(m["layer"])
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in b["workloads"]:  # setup_s, another end-to-end metric and a per-layer one
        e = [m for m in b["end_to_end"] if w["name"] in m.get("workloads", cells)]
        p = [m for m in b["per_layer"] if w["name"] in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in e} and len(e) >= 2 and p


def test_every_name_resolves_to_its_files():
    b = bench()
    for w in b["workloads"]:
        cell = harness.resolve(b, w["name"], ROOT)
        assert cell.net["name"] == w["config"]
        assert (PB / "traffic" / f"{w['traffic']}.json").is_file()
        assert (PB / "systems" / f"{cell.net['system']}.py").is_file()
        assert (PB / "loops" / f"{cell.traffic['loop']}.py").is_file()
        for fn in ("prepare", "inputs", "out_shape", "build", "reference_fn", "control"):
            assert callable(getattr(cell.system, fn))
        assert callable(cell.loop.pool_rows) and callable(cell.loop.run)
        assert {m.name for m in cell.end_to_end} >= {"setup_s", "images_per_s"}
        assert cell.per_layer and all(callable(m.read) for m in cell.per_layer)
    for m in b["end_to_end"] + b["per_layer"]:
        assert (PB / "metrics" / f"{m['name']}.py").is_file()


def small(cell, batch, pool=2, traced=2):
    cell.traffic = dict(cell.traffic, batch=batch, input_pool_batches=pool,
                        trace_batches=traced, warmup_batches=1)
    return cell


@pytest.mark.parametrize("name,batch,n_dev", [("kws_int8.bulk", 32, 1),
                                              ("vww_int8.bulk_4chips", 8, 4)])
@pytest.mark.parametrize("traced", [False, True])
def test_cpu_rehearsal(name, batch, n_dev, traced):
    """The whole run through the port's plain paths on the CPU (the mesh
    over the CPU repeated); no device metric is written from it."""
    cell = small(harness.resolve(bench(), name, ROOT), batch)
    r = harness.run_cell(cell, 2**31 + 3, 0.2, traced, [torch.device("cpu")] * n_dev,
                         time.perf_counter())
    assert r.correct, r.checks
    assert list(r.line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r.line)[-1] == "checks"
    if traced:
        assert set(r.line["metrics"]) == {"executor_host_ms"}
        assert r.line["breakdown"]["device_ops"] == []
    else:
        assert set(r.line["metrics"]) == {"images_per_s", "arena_bytes", "setup_s"}
        want = {"kws_int8.bulk": 16000, "vww_int8.bulk_4chips": 55296}[name]
        assert r.line["metrics"]["arena_bytes"]["value"] == want


def test_a_cell_added_as_new_files_is_found(tmp_path):
    """A configuration, a traffic mix and a metric added as files, with
    entries in BENCHMARK.json, and no file of the harness edited."""
    shutil.copytree(PB, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    cfg = {"name": "tiny_int8", "system": "int8_cnn", "input_shape": [1, 8, 8],
           "num_classes": 3,
           "layers": [{"name": "c1", "op": "conv", "cout": 4, "kernel": [3, 3],
                       "stride": [1, 1], "padding": [1, 1], "relu": True},
                      {"name": "d1", "op": "dw", "kernel": [3, 3], "stride": [2, 2],
                       "padding": [1, 1], "relu": True},
                      {"name": "p1", "op": "conv", "cout": 8, "kernel": [1, 1],
                       "stride": [1, 1], "padding": [0, 0], "relu": True,
                       "pool": {"op": "avg", "kernel": [4, 4], "stride": [4, 4]}},
                      {"name": "fc", "op": "fc", "in": 8, "out": 3}],
           "weights": {"init": "he_normal", "bias_std": 0.1},
           "inputs": {"dist": "normal", "calibration_images": 16}}
    (tmp_path / "perfbench/configs/tiny_int8.json").write_text(json.dumps(cfg))
    (tmp_path / "perfbench/traffic/tiny.json").write_text(json.dumps(
        {"loop": "closed", "batch": 16, "lookahead": 1, "input_pool_batches": 2,
         "warmup_batches": 1, "trace_batches": 2}))
    (tmp_path / "perfbench/metrics/calls_per_s.py").write_text(
        "def read(rec):\n    return rec.batches / rec.window_s\n")
    b["configs"].append({"name": "tiny_int8", "source": "https://example.org/tiny",
                         "file": "perfbench/configs/tiny_int8.json", "reduced": [],
                         "why": "a test"})
    b["workloads"].append({"name": "tiny.t", "config": "tiny_int8", "traffic": "tiny",
                           "chips": 1, "why": "a test"})
    b["end_to_end"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher",
                            "bound": 0.05, "source": "host_clock", "workloads": ["tiny.t"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = harness.resolve(harness.load_bench(tmp_path), "tiny.t", tmp_path)
    assert cell.net["name"] == "tiny_int8" and cell.traffic["batch"] == 16
    assert "calls_per_s" in {m.name for m in cell.end_to_end}
    r = harness.run_cell(cell, 5, 0.2, False, [torch.device("cpu")], time.perf_counter())
    assert r.correct, r.checks
    assert r.line["metrics"]["calls_per_s"]["value"] > 0


def _run_py(cwd, *args):
    return subprocess.run([sys.executable, "perfbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_run_py_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run_py(ROOT, "--workload", "kws_int8.bulk", "--seed", str(2**31 + 9),
                "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and not p.stdout.strip()
    assert "needs 1 CUDA card" in p.stderr


def test_run_py_in_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copytree(PB, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = _run_py(tmp_path, "--workload", "kws_int8.bulk", "--seed", "1", "--seconds", "1")
    assert p.returncode != 0 and not p.stdout.strip()


FORBIDDEN_TOP = {"jax", "jaxlib", "flax", "repro"}


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in PB.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN_TOP, f"{path}: imports {n}"


def test_a_run_loads_no_jax_module():
    """Compares the top-level name whole: ``repro_torch`` is allowed,
    ``repro`` is not."""
    code = (
        "import sys, time, torch; sys.path[:0] = ['.', 'src']\n"
        "from perfbench import harness\n"
        "cell = harness.resolve(harness.load_bench(), 'kws_int8.bulk')\n"
        "cell.traffic = dict(cell.traffic, batch=8, input_pool_batches=1,\n"
        "                    warmup_batches=1)\n"
        "r = harness.run_cell(cell, 1, 0.1, False, [torch.device('cpu')], time.perf_counter())\n"
        "assert r.correct\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(harness.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    tops, bad = p.stdout.strip().splitlines()[-2:]
    assert "repro_torch" in tops and bad == "[]"
    assert not FORBIDDEN_TOP & set(ast.literal_eval(tops))


@pytest.mark.card
def test_run_py_on_a_card(card):
    p = _run_py(ROOT, "--workload", "kws_int8.bulk", "--seed", str(2**31 + 21),
                "--seconds", "1", "--trace", "0")
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert line["metrics"]["arena_bytes"]["value"] == 16000


def test_the_four_card_cells_files_run_on_a_cpu_mesh():
    """``traffic/bulk_4chips.json`` and ``metrics/mesh_busy_share.py``
    resolve for the four-card cell and run over a mesh of the CPU repeated
    four times."""
    cell = harness.resolve(bench(), "vww_int8.bulk_4chips", ROOT)
    assert cell.chips == 4 and cell.traffic["batch"] == 32768
    assert "mesh_busy_share" in {m.name for m in cell.per_layer}
    r = harness.run_cell(small(cell, 8), 2**31 + 4, 0.2, False, [torch.device("cpu")] * 4,
                         time.perf_counter())
    assert r.correct, r.checks


def _copy_of_the_benchmark(tmp_path):
    shutil.copytree(PB, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    return bench()


OPEN_LOOP = '''"""Open loop: requests of ``rows`` rows arriving at ``rate_per_s``, one
at a time, each waited on."""
import time

import numpy as np

from perfbench.harness import LoopResult, sync


def pool_rows(traffic):
    return int(traffic["pool_requests"]) * int(traffic["rows"])


def run(ctx):
    rows, n = int(ctx.traffic["rows"]), int(ctx.traffic["pool_requests"])
    gaps = np.random.default_rng(0).exponential(1.0 / float(ctx.traffic["rate_per_s"]), 4096)

    def call(i):
        s = (i % n) * rows
        return s, ctx.run(ctx.params, ctx.pool[s:s + rows].to(ctx.devices[0])).cpu().numpy()

    call(0)
    sync(ctx.devices)
    res = LoopResult(setup_end=time.perf_counter(), rows_per_call=rows)
    ctx.window_opens()
    t0 = due = time.perf_counter()
    i = 0
    while due < t0 + ctx.seconds:
        while time.perf_counter() < due:
            pass
        t = time.perf_counter()
        res.outputs.append(call(i))
        res.host_call_s.append(time.perf_counter() - t)
        due += gaps[i % len(gaps)]
        i += 1
    res.window_s, res.calls, res.dispatched_rows = time.perf_counter() - t0, i, i * rows
    return res
'''


def test_an_open_loop_mix_added_as_new_files_only(tmp_path):
    """A traffic mix whose generator is new code: ``loops/<loop>.py``, the
    mix's data file, a metric reader and the entries; no file of the
    harness edited."""
    b = _copy_of_the_benchmark(tmp_path)
    (tmp_path / "perfbench/loops/poisson.py").write_text(OPEN_LOOP)
    (tmp_path / "perfbench/traffic/poisson_small.json").write_text(json.dumps(
        {"loop": "poisson", "rows": 4, "pool_requests": 8, "rate_per_s": 200}))
    (tmp_path / "perfbench/metrics/call_ms_p95.py").write_text(
        "import numpy as np\n\n\ndef read(rec):\n"
        "    return 1e3 * float(np.percentile(rec.host_call_s, 95))\n")
    b["workloads"].append({"name": "kws_int8.poisson", "config": "ds_cnn_kws_int8",
                           "traffic": "poisson_small", "chips": 1, "why": "a test"})
    b["end_to_end"].append({"name": "call_ms_p95", "unit": "ms", "better": "lower",
                            "bound": 0.05, "source": "host_clock",
                            "workloads": ["kws_int8.poisson"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = harness.resolve(harness.load_bench(tmp_path), "kws_int8.poisson", tmp_path)
    assert cell.loop.__file__.endswith("poisson.py")
    r = harness.run_cell(cell, 2**31 + 6, 0.3, False, [torch.device("cpu")], time.perf_counter())
    assert r.correct, r.checks
    assert r.checks["rows_compared"]["value"] >= 8
    assert r.line["metrics"]["call_ms_p95"]["value"] > 0
    assert r.line["metrics"]["arena_bytes"]["value"] == 16000


AFFINE = '''"""A kind of system other than a CNN: int8 rows times an int8 matrix,
saturated to int8; the program is a torch matmul, the reference numpy."""
import numpy as np
import torch


def prepare(net, gen, device):
    return torch.randint(-3, 4, (net["out"], net["in"]), generator=gen, device=device).cpu()


def out_shape(net):
    return (net["out"],)


def inputs(net, data, rows, gen, device):
    return torch.randint(-8, 8, (rows, net["in"]), generator=gen, device=device).to(
        torch.int8).cpu()


class System:
    def __init__(self, w):
        self.params = w
        self.run = lambda p, x: (x.to(torch.int32) @ p.T.to(torch.int32)).clamp(-128, 127).to(
            torch.int8)

    def readings(self):
        return {}

    def checks(self, readings):
        return {}

    def close(self):
        self.params = None


def build(net, data, devices, spans):
    return System(data.to(devices[0]))


def reference_fn(net, data, device):
    w = data.numpy().astype(np.int64)
    return lambda x: torch.from_numpy(
        np.clip(x.numpy().astype(np.int64) @ w.T, -128, 127).astype(np.int8))


def control(net, data, device):
    return lambda params, x: torch.zeros((len(x), net["out"]), dtype=torch.int8)
'''


def test_a_system_kind_added_as_new_files_only(tmp_path):
    """A configuration of a new kind: ``systems/<kind>.py`` with its builder
    and reference, its configuration file and entry; the closed loop and
    the harness unchanged, and its control comes out not correct."""
    b = _copy_of_the_benchmark(tmp_path)
    (tmp_path / "perfbench/systems/affine_int8.py").write_text(AFFINE)
    (tmp_path / "perfbench/configs/affine_small.json").write_text(json.dumps(
        {"name": "affine_small", "system": "affine_int8", "in": 16, "out": 5}))
    b["configs"].append({"name": "affine_small", "source": "https://example.org/affine",
                         "file": "perfbench/configs/affine_small.json", "reduced": [],
                         "why": "a test"})
    b["workloads"].append({"name": "affine.bulk", "config": "affine_small", "traffic": "bulk",
                           "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = small(harness.resolve(harness.load_bench(tmp_path), "affine.bulk", tmp_path), 32)
    r = harness.run_cell(cell, 2**31 + 8, 0.2, False, [torch.device("cpu")], time.perf_counter())
    assert r.correct, r.checks
    assert r.line["metrics"]["images_per_s"]["value"] > 0
    assert "arena_bytes" not in r.line["metrics"]
    bad = harness.run_cell(cell, 2**31 + 8, 0.1, False, [torch.device("cpu")],
                           time.perf_counter(), timed=cell.system.control)
    assert not bad.correct
