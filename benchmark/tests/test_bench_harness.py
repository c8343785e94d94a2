"""The harness's own arithmetic and files: BENCHMARK.json's names, the
operation counters, the metric readers, a cell added by files alone, and
what a run imports."""

import ast
import json
import math
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

from benchmark.flops import model as FL
from benchmark.harness import find_cell, read_metrics
from benchmark.tests import tiny

ROOT = tiny.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_and_units_use_the_allowed_characters():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = []
    for c in BENCH["configs"]:
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert (ROOT / c["file"]).exists()
    for w in BENCH["workloads"]:
        names += [w["name"], w["config"], w["traffic"]]
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert all(NAME.match(n) for n in names), names
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)


def test_every_cell_finds_its_files_and_metrics():
    for w in BENCH["workloads"]:
        cell = find_cell(ROOT, w["name"])
        assert "setup_s" in [m["name"] for m in cell["end_to_end"]]
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
        assert cell["limits"], f"{w['name']} has no limits file"
        for m in cell["end_to_end"] + cell["per_layer"]:
            assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()


def test_counters_against_hand_counts():
    cfg = dict(tiny.CAUSAL)  # dim 64, ffn 128, 2 layers, 16 tokens a frame, text 16
    w = FL.causal_block(cfg, ctx_frames=9, steps=4)
    t, skv, d = 48, 144, 64
    layer = 2 * t * (6 * d * d + 2 * d * 128)
    embed = 2 * t * d * 4 * (4 + 4)
    fwd = 2 * layer + embed + 2 * (4 * t * skv * d + 4 * t * 16 * d)
    commit = layer + 2 * t * 2 * d * d + 2 * t * d * 16 + 4 * t * skv * d + 4 * t * 16 * d
    assert w["model"] == 4 * fwd + commit
    assert w["k1_calls"] == 4 * 2 + 1
    assert w["k1"] == 9 * 4 * t * skv * d
    assert w["k1_bytes"] == 9 * ((2 * t * d + 2 * skv * d) * 2 + skv * 4)
    # the published shapes: one decode call is 0.5443 ms of work at 989 TFLOP/s
    full = json.loads((ROOT / "benchmark/configs/longlive-1.3b.json").read_text())
    one = FL.Work()
    FL.k1_call(one, 1, 4680, 18720, 1536)
    assert math.isclose(one["k1_least_s"], 4 * 4680 * 18720 * 1536 / 989e12)
    assert FL.causal_block(full, 12, 4)["k1_calls"] == 149
    assert FL.recache(full, 12)["k1_calls"] == 29
    assert FL.decode_frame(full, full["vae"], False)["k2_calls"] == 30
    assert FL.decode_frame(full, full["vae"], True)["k2_calls"] == 28


def _ctx(world=1):
    return types.SimpleNamespace(world=world, setup_s=12.5, device=types.SimpleNamespace(type="cuda"),
                                 root=ROOT)


def _metric(name, rec, world=1):
    m = [x for x in BENCH["end_to_end"] + BENCH["per_layer"] if x["name"] == name]
    return read_metrics(m, rec, _ctx(world)).get(name, {}).get("value")


def _serve_rec(gaps_ms, switch_ms=()):
    t = sum(gaps_ms) / 1e3
    return {"window_s": t, "pixel_frames": 12 * len(gaps_ms), "gaps_ms": list(gaps_ms),
            "switch_ms": list(switch_ms), "latent_frames": 3 * len(gaps_ms), "spans": {},
            "work": {"model": 1e15}}


def test_a_stall_lowers_fps_and_raises_switch_ms():
    steady = _serve_rec([660.0] * 40, [1040.0] * 10)
    stalled = _serve_rec([660.0] * 39 + [2660.0], [1040.0] * 9 + [3040.0])
    assert _metric("fps", stalled) < _metric("fps", steady)
    assert math.isclose(_metric("fps", steady), 480 / 26.4)
    assert math.isclose(_metric("fps", stalled), 480 / 28.4)  # all the work over all the time
    assert _metric("switch_ms", stalled) == pytest.approx(1240.0)
    assert _metric("gap_p95_ms.serve", steady) == pytest.approx(660.0)
    assert _metric("mfu.serve", steady) == pytest.approx(100 * 1e15 / (26.4 * 989e12))


def test_step_ms_is_the_window_over_its_steps():
    rec = {"window_s": 30.5, "steps": 20, "work": {}}
    assert _metric("step_ms", rec) == pytest.approx(1525.0)
    assert _metric("setup_s", rec) == 12.5


def test_rooflines_and_idle_read_the_trace():
    trace = {"window_s": 5.0, "busy_s": 4.6, "groups": {"K1": 1.0, "K2": 0.5, "gemm": 1.0,
                                                         "glue": 2.0}}
    rec = {"trace": trace, "traced_latent_frames": 18, "traced_steps": 3,
           "traced_work": {"k1_least_s": 0.52, "k2_least_s": 0.25}, "work": {}}
    assert _metric("k1_roofline.serve", rec) == pytest.approx(52.0)
    assert _metric("k2_roofline.serve", rec) == pytest.approx(50.0)
    assert _metric("idle_pct.serve", rec) == pytest.approx(8.0)
    assert _metric("glue_ms_per_frame.serve", rec) == pytest.approx(2000.0 / 18)
    assert _metric("glue_ms_per_step.t2v", rec) == pytest.approx(2500.0 / 3)
    # without a trace a reader returns nothing, never 0
    assert _metric("k1_roofline.serve", {"work": {}}) is None
    assert _metric("idle_pct.t2v", {"work": {}}) is None


def test_a_cell_added_by_files_alone_runs(tmp_path):
    """A new traffic mix, a new per-layer metric and a new cell: data files,
    a reader and BENCHMARK.json entries; no file of the harness edited."""
    root = tiny.make_root(tmp_path, 1e-3)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*.py")}
    mix = json.loads((root / "benchmark/traffic/live.json").read_text())
    mix.update(segment_frames=6, warmup_frames=12)
    (root / "benchmark/traffic/live_long_segments.json").write_text(json.dumps(mix))
    (root / "benchmark/metrics/segments.serve.py").write_text(
        "def read(rec, ctx):\n    return float(rec['segments'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "stream6", "config": "tiny-causal",
                               "traffic": "live_long_segments", "chips": 1, "why": "added"})
    bench["end_to_end"][0]["workloads"].append("stream6")
    bench["per_layer"].append({"name": "segments.serve", "unit": "1", "better": "higher",
                               "source": "host_clock", "layer": "serving loop",
                               "moves": "fps", "workloads": ["stream6"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(root / "benchmark/limits/stream.json", root / "benchmark/limits/stream6.json")
    d = tiny.run(root, "stream6", seconds=0.5)
    assert d["correct"] and "fps" in d["metrics"]
    d = tiny.run(root, "stream6", seconds=0.5, trace=1)
    assert d["metrics"]["segments.serve"]["value"] >= 1
    assert before == {p: p.read_bytes() for p in before}


def _top_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


FORBIDDEN = {"jax", "jaxlib", "flax", "longlive_tpu"}


def test_no_source_imports_jax_or_the_jax_package():
    for p in (ROOT / "benchmark").rglob("*.py"):
        assert not set(_top_imports(p)) & FORBIDDEN, p
    for p in (ROOT / "benchmark" / "reference").rglob("*.py"):
        assert set(_top_imports(p)) <= {"torch", "numpy", "math", "contextlib", "typing",
                                        "__future__"}, p


def test_a_run_holds_no_jax_module(tmp_path):
    """A tiny run in a process of its own, then its modules' top-level names."""
    root = tiny.make_root(tmp_path, 1e-3)
    code = (
        "import sys, json; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from benchmark.tests import tiny\n"
        "from pathlib import Path\n"
        "tiny.run(Path(%r), 'steer', seconds=0.3)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    ) % (str(root), str(ROOT), str(root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "longlive_torch" in mods and not mods & FORBIDDEN


def test_the_jax_check_compares_whole_top_level_names(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "longlive_tpu_like", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("y"))
    assert harness.forbidden_modules() == ["jax"]


def test_a_run_without_a_card_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "stream",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""
