"""The driver-facing benchmark artifact must always emit one valid JSON
line with the expected schema (worker mode; CPU, tiny config)."""

import json
import os
import subprocess
import sys


def test_bench_worker_json_schema():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run(
        [sys.executable, os.path.join(root, "bench.py"),
         "--cpu", "--nside", "16", "--nfreq", "4",
         "--repeats", "1", "--fchunk", "4"],
        # 900 s: the cold-cache table build is ~15 s alone, and the
        # timeout must survive ~10x contention on a shared test machine.
        capture_output=True, text=True, timeout=900, cwd=root, env=env,
    )
    assert r.returncode == 0, r.stderr[-800:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, r.stdout
    rec = json.loads(lines[0])
    assert {"metric", "value", "unit", "vs_baseline"} <= set(rec)
    assert rec["unit"] == "s" and rec["value"] > 0
    assert "Nside=16" in rec["metric"]
    # MFU/FLOP reporting (VERDICT r1 item 10)
    assert rec["flops"] > 0 and rec["tflops"] >= 0
    assert rec["flops_source"] in ("xla", "analytic")


def _load_bench():
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(root, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_peak_lookup():
    """An H100 device kind gives the data-sheet f32 peak; an unknown kind
    (or a precision below HIGHEST) gives none, so no mfu is reported."""
    bench = _load_bench()
    peak = bench.peak_for("NVIDIA H100 80GB HBM3")
    assert peak["f32_flops"] == 67e12 and peak["hbm_bytes_s"] == 3.35e12
    assert bench.peak_for("NVIDIA H100 80GB HBM3", "high") is None
    assert bench.peak_for("cpu") is None
    assert bench.peak_for("some future accelerator") is None


def test_chip_smoke_refuses_cpu():
    """chip_smoke.py on a CPU-only JAX exits non-zero and never prints
    the ok line."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(root, "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, cwd=root, env=env,
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr
