"""Benchmark: BAM reads/s/chip through the full getclip + realign + getsv
pipeline on the reference example data, with output parity asserted.

Baseline (BASELINE.md): the reference binaries do getclip (0.032 s) +
getsv (0.058 s) for 16,730 records on one CPU core ~= 1.86e5 reads/s
through the pipeline (realignment excluded there because bwa is a separate
process; it is INCLUDED in our timing, which is conservative in our favor's
opposite direction).

Prints exactly one JSON line.
"""
import io
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

EXAMPLE = "/root/reference/example"
BASELINE_READS_PER_S = 16730 / (0.032 + 0.058)


def run_pipeline(tmpdir: str):
    from seeksv_tpu.io.bam import read_bam
    from seeksv_tpu.pipeline.driver import realign_clips
    from seeksv_tpu.pipeline.getclip import getclip
    from seeksv_tpu.pipeline.getsv import getsv

    t0 = time.time()
    recs = read_bam(f"{EXAMPLE}/cancer.sort.bam")
    prefix = os.path.join(tmpdir, "cancer")
    getclip(f"{EXAMPLE}/cancer.sort.bam", prefix, recs=recs)
    sam_path = os.path.join(tmpdir, "cancer.clip.sam")
    realign_clips(f"{EXAMPLE}/reference/example.fa", f"{prefix}.clip.fq.gz",
                  sam_path)
    sv_path = os.path.join(tmpdir, "cancer.sv")
    getsv(sam_path, f"{EXAMPLE}/cancer.sort.bam", f"{prefix}.clip.gz",
          sv_path, os.path.join(tmpdir, "r.fq"), filtered_out=io.StringIO(),
          recs=recs)
    dt = time.time() - t0
    with open(sv_path, "rb") as f, open(f"{EXAMPLE}/cancer.sv", "rb") as g:
        assert f.read() == g.read(), "parity violation in bench run"
    return recs.n, dt


def main():
    import tempfile

    import jax

    from seeksv_tpu.utils.compile_cache import configure_compile_cache
    configure_compile_cache()
    dev = jax.devices()[0]

    with tempfile.TemporaryDirectory() as d:
        # warmup (jit compile, index + page cache)
        run_pipeline(d)
    best = None
    n = 0
    for _ in range(7):
        with tempfile.TemporaryDirectory() as d:
            n, dt = run_pipeline(d)
            best = dt if best is None else min(best, dt)
    value = n / best
    print(json.dumps({
        "metric": "bam_reads_per_s_chip_full_pipeline",
        "value": round(value, 1),
        "unit": "reads/s",
        "vs_baseline": round(value / BASELINE_READS_PER_S, 4),
        "jax_platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }))


if __name__ == "__main__":
    main()
