"""RSS evidence for the windowed getsv-phase junction build
(VERDICT r4 #9): on a clip-dense dataset, the live set of decoded clip
groups during spmd_build_junctions is ONE window (window_groups=4096),
so the phase's peak memory scales with the window size — not with the
clip-table size.  This script measures the junction phase in a fresh
subprocess per configuration (windowed vs unbounded) and appends one
JSON row; the structural invariant (max live window length <=
window_groups, identical junction table) is asserted by
tests/test_stream_spmd.py.

Usage: python scripts/bench_junction_window.py [--genome-mb 20]
       [--coverage 30] [--events 4000] [--out junction_window.jsonl]
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_CHILD = r"""
import os, sys, time
sys.path.insert(0, sys.argv[5])
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=1")
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from jax.sharding import Mesh
from seeksv_tpu.parallel.spmd_pipeline import spmd_build_junctions


def vm_hwm_mb():
    # NOT ru_maxrss: Linux carries ru_maxrss across fork+exec in the
    # signal struct, so a subprocess inherits its parent's high-water
    # mark; VmHWM is per-mm and resets at exec
    with open("/proc/self/status") as f:
        for ln in f:
            if ln.startswith("VmHWM:"):
                return int(ln.split()[1]) / 1024
    return 0.0


clip_gz, clip_sam, window = sys.argv[1], sys.argv[2], int(sys.argv[3])
mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "gp"))
print(f"rss after imports: {vm_hwm_mb():.1f}", file=sys.stderr)
t0 = time.time()
jmap, rescue = spmd_build_junctions(mesh, clip_gz, clip_sam, 0, False,
                                    window_groups=window)
dt = time.time() - t0
print(f"{window}\t{len(jmap.items)}\t{dt:.2f}\t{vm_hwm_mb():.1f}")
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-mb", type=float, default=20)
    ap.add_argument("--coverage", type=int, default=30)
    ap.add_argument("--events", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from scripts.bench_scale import build_dataset
    G = int(args.genome_mb * 1e6)
    key = (f"scale-G{G}-c{args.coverage}-l100-s{args.seed}"
           f"-e{args.events}")
    root = os.path.join(os.path.expanduser("~"), ".cache", "seeksv_tpu", key)
    build_dataset(root, G, args.coverage, 100, args.seed, args.events, False)

    import io

    from seeksv_tpu.pipeline.driver import realign_clips
    from seeksv_tpu.pipeline.getclip import getclip

    with tempfile.TemporaryDirectory() as d:
        prefix = os.path.join(d, "x")
        getclip(os.path.join(root, "sim.bam"), prefix)
        realign_clips(os.path.join(root, "ref.fa"), f"{prefix}.clip.fq.gz",
                      f"{prefix}.clip.sam")
        import gzip
        n_lines = sum(1 for _ in gzip.open(f"{prefix}.clip.gz"))
        child = os.path.join(d, "child.py")
        with open(child, "w") as f:
            f.write(_CHILD)
        rows = {}
        for window in (4096, 1 << 30):
            r = subprocess.run(
                [sys.executable, child, f"{prefix}.clip.gz",
                 f"{prefix}.clip.sam", str(window), "-",
                 os.path.dirname(os.path.dirname(os.path.abspath(__file__)))],
                capture_output=True, text=True, check=True)
            print(r.stderr[-500:], file=sys.stderr)
            w, nj, dt, rss = r.stdout.strip().split("\n")[-1].split("\t")
            rows[int(w)] = dict(n_junctions=int(nj), phase_s=float(dt),
                                peak_rss_mb=float(rss))
    windowed = rows[4096]
    unbounded = rows[1 << 30]
    assert windowed["n_junctions"] == unbounded["n_junctions"], rows
    result = {
        "metric": "junction_window_rss",
        "genome_mb": args.genome_mb, "coverage": args.coverage,
        "events": args.events, "clip_lines": n_lines,
        "window_groups": 4096,
        "windowed_peak_rss_mb": windowed["peak_rss_mb"],
        "unbounded_peak_rss_mb": unbounded["peak_rss_mb"],
        "rss_saved_mb": round(unbounded["peak_rss_mb"]
                              - windowed["peak_rss_mb"], 1),
        "windowed_phase_s": windowed["phase_s"],
        "unbounded_phase_s": unbounded["phase_s"],
        "n_junctions": windowed["n_junctions"],
        "note": "getsv-phase junction build, 1-device mesh subprocesses; "
                "the windowed live set is one 4096-group window "
                "(spmd_build_junctions), the unbounded arm materializes "
                "the whole clip table",
    }
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
