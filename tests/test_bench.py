"""bench.py end to end at the BENCH_SMALL size, on the CPU backend."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_bench(**env):
    e = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    return subprocess.run([sys.executable, os.path.join(ROOT, "bench.py")],
                          capture_output=True, text=True, env=e, timeout=900)


def test_bench_refuses_cpu_without_small():
    # a measurement path that finds no GPU fails; it never silently shrinks
    r = _run_bench()
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert not r.stdout.strip()


def test_bench_small_runs_and_names_device():
    # both GI modes' SSIM settle loops: each mode builds its FrameState from
    # its own config (the fast graph's interleave cache has its own shape)
    r = _run_bench(BENCH_SMALL="1", BENCH_FRAMES="2")
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["device"]["platform"] == "cpu"
    assert out["device"]["kind"] == "cpu" and out["device"]["count"] >= 1
    assert out["value"] > 0
    assert 0.0 < out["gi_fast_ssim_vs_reference"] <= 1.0
    assert out["reference_gi_frame_ms"] > 0
