"""Device-time breakdown of bench.py's step from a profiler trace.

    python tools/trace_step.py --nside 1024 --nfreq 64 --legmode scan \
        --out trace_1024

Builds the step as bench.py does, compiles it, runs one warm-up and two
timed steps (host clock around block_until_ready), then traces one step
with jax.profiler and reduces the trace to device time per synthesis
stage (the jax.named_scope names: draw / legendre / ring_eq / ring_cap),
with the Legendre stage split into matmul kernels (the contraction) and
the rest (the λ recurrence in scan mode).  A kernel's stage is read from
the op metadata of the compiled program's HLO (kernel ``fusion_12`` is
instruction ``fusion.12``), else from the event's ``hlo_op`` or its
op-name path; matmul kernels that map to no instruction (library calls
inside CUDA graphs) are counted as ``matmul_unattributed``.  Writes
``summary.json`` and the HLO text (``hlo.txt.gz``) and prints the
summary; needs a GPU.
"""

import argparse
import glob
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

import bench

STAGES = ("draw", "ring_eq", "ring_cap", "legendre")


def op_stages(hlo_text):
    """HLO instruction name → innermost named stage (or 'other')."""
    out = {}
    for m in re.finditer(r"%?([\w.\-]+) = [^\n]*?op_name=\"([^\"]*)\"",
                         hlo_text):
        name, path = m.group(1), m.group(2).split("/")
        out[name] = next((s for s in STAGES if s in path), "other")
    return out


def is_matmul(ev_name, hlo_op):
    s = f"{ev_name} {hlo_op}".lower()
    return any(k in s for k in ("gemm", "cublas", "dot", "matmul", "cutlass"))


def stage_of(ev_name, st, stages):
    """Stage of one device event (see the module docstring)."""
    for key in (re.sub(r"_(\d+)$", r".\1", ev_name), str(st.get("hlo_op"))):
        if key in stages:
            stg = stages[key]
            break
    else:
        path = str(st.get("name", "")).split("/")
        stg = next((s for s in STAGES if s in path), "other")
    if is_matmul(ev_name, st.get("hlo_op", "")):
        return "legendre_matmul" if stg == "legendre" else (
            "matmul_unattributed" if stg == "other" else stg)
    return "legendre_recurrence" if stg == "legendre" else stg


def reduce_trace(path, stages):
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    per = {}
    intervals = []
    lines_seen = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = [ev for ev in line.events
                   if dict(ev.stats).get("hlo_op") is not None]
            lines_seen[line.name] = len(evs)
            for ev in evs:
                stg = stage_of(ev.name, dict(ev.stats), stages)
                per[stg] = per.get(stg, 0.0) + ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy = 0.0
    window = 0.0
    if intervals:
        intervals.sort()
        cur0, cur1 = intervals[0]
        for a, b in intervals[1:]:
            if a > cur1:
                busy += cur1 - cur0
                cur0, cur1 = a, b
            else:
                cur1 = max(cur1, b)
        busy += cur1 - cur0
        window = intervals[-1][1] - intervals[0][0]
    total = sum(per.values())
    return {
        "device_s_by_stage": {k: v / 1e9 for k, v in sorted(per.items())},
        "share_by_stage": {k: v / total for k, v in sorted(per.items())}
        if total else {},
        "device_busy_s": busy / 1e9,
        "device_window_s": window / 1e9,
        "lines": lines_seen,
    }


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--nside", type=int, default=1024)
    p.add_argument("--nfreq", type=int, default=64)
    p.add_argument("--fchunk", type=int, default=4)
    p.add_argument("--fleg", type=int, default=None)
    p.add_argument("--lchunk", type=int, default=64)
    p.add_argument("--legmode", default="scan", choices=["cached", "scan"])
    p.add_argument("--fft", default="xla", choices=["mm", "xla"])
    p.add_argument("--cmul", default="xla", choices=["xla", "karatsuba"])
    p.add_argument("--out", required=True)
    args = p.parse_args()

    from cora_tpu.healpix.sht import get_sht
    from cora_tpu.util.compute import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"trace_step: needs a GPU, found {dev.platform}")
    nside, nz = args.nside, args.nfreq
    lmax = 3 * nside - 1
    freqs = np.linspace(400.0, 800.0, nz, endpoint=False)
    roots = bench.device_roots(freqs, lmax)
    if args.legmode == "scan" and args.fft == "xla":
        op = get_sht(nside, lmax, l_chunk=args.lchunk)  # the library op
    else:
        op = bench.build_sht(nside, lchunk=args.lchunk, legmode=args.legmode,
                             fft_mode=args.fft, cmul=args.cmul)
    t = op.tables(False)
    fleg = bench.default_fleg(nside, nz, args.fchunk, args.fleg)
    step = jax.jit(bench.make_step(op, nz, fleg, args.fchunk))
    keys = [jax.random.key(i, impl="rbg") for i in range(4)]
    t0 = time.time()
    compiled = step.lower(keys[0], roots, t).compile()
    compile_s = time.time() - t0
    compiled(keys[0], roots, t).block_until_ready()
    times = []
    for k in keys[1:3]:
        t0 = time.time()
        compiled(k, roots, t).block_until_ready()
        times.append(time.time() - t0)
    os.makedirs(args.out, exist_ok=True)
    with jax.profiler.trace(args.out):
        compiled(keys[3], roots, t).block_until_ready()
    path = sorted(glob.glob(os.path.join(args.out, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    summary = {
        "config": vars(args) | {"fleg": fleg, "fft_mode": op.fft_mode,
                                "fft_cmul": op.fft_cmul,
                                "legendre_mode": op.legendre_mode},
        "device": dev.device_kind,
        "compile_s": compile_s,
        "step_s": times,
        **reduce_trace(path, op_stages(compiled.as_text())),
    }
    with open(os.path.join(args.out, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    import gzip

    with gzip.open(os.path.join(args.out, "hlo.txt.gz"), "wt") as fh:
        fh.write(compiled.as_text())
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
