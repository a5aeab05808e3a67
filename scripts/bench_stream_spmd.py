"""Scale artifact: streaming x SPMD composition at >= 100Mbp/30x on a
virtual 8-device mesh, with bounded RSS recorded and sv-row parity vs
the sequential streaming pass (VERDICT r2 item 3 'Done' criterion).

Runs on CPU devices (XLA_FLAGS=--xla_force_host_platform_device_count=8)
— the same virtual-mesh configuration the test suite uses — so this
validates the composition's memory behavior and exactness, not chip
throughput.  Prints one JSON line.

Usage: python scripts/bench_stream_spmd.py [--genome-mb 100]
       [--coverage 30] [--devices 8] [--chunk-records 2000000]
"""
import argparse
import json
import os
import resource
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-mb", type=float, default=100)
    ap.add_argument("--coverage", type=int, default=30)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--events", type=int, default=3000)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--sweep", default=None,
                    help="comma list of mesh sizes to run in one process "
                         "(e.g. 1,2,4,8; the virtual device count is the "
                         "max); sequential baseline measured once")
    ap.add_argument("--chunk-records", type=int, default=2_000_000)
    ap.add_argument("--trials", type=int, default=2,
                    help="best-of-N per configuration (both sides)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sweep = ([int(x) for x in args.sweep.split(",")] if args.sweep
             else [args.devices])
    args.devices = max(sweep)

    # backend creation is lazy, so switching platform + forcing host
    # devices here (before any jax.devices() call) works — the same
    # recipe as tests/conftest.py
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={args.devices}").strip()
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    from jax.sharding import Mesh

    from seeksv_tpu.parallel.stream_spmd import spmd_run_pipeline_streaming
    from seeksv_tpu.pipeline.stream import run_pipeline_streaming

    from bench_scale import build_dataset, sv_rows  # same cached dataset

    G = int(args.genome_mb * 1e6)
    key = (f"scale-G{G}-c{args.coverage}-l{args.read_len}-s{args.seed}"
           f"-e{args.events}")
    root = os.path.join(os.path.expanduser("~"), ".cache", "seeksv_tpu", key)
    build_dataset(root, G, args.coverage, args.read_len, args.seed,
                  args.events, False)
    bam = os.path.join(root, "sim.bam")
    fa = os.path.join(root, "ref.fa")

    with tempfile.TemporaryDirectory() as d:
        seq_totals = []
        for _ in range(max(1, args.trials)):
            t0 = time.time()
            seq_prefix = os.path.join(d, "seq")
            run_pipeline_streaming(fa, bam, seq_prefix,
                                   chunk_records=args.chunk_records)
            seq_totals.append(round(time.time() - t0, 2))
        t_seq = min(seq_totals)
        want = sv_rows(seq_prefix + ".sv")

        all_exact = True
        for nd in sweep:
            devs = np.array(jax.devices()[:nd])
            if nd % 2 == 0 and nd > 1:
                mesh = Mesh(devs.reshape(nd // 2, 2), ("dp", "gp"))
            else:
                mesh = Mesh(devs.reshape(nd, 1), ("dp", "gp"))
            spmd_totals = []
            for _ in range(max(1, args.trials)):
                t0 = time.time()
                spmd_prefix = os.path.join(d, f"spmd{nd}")
                stages = {}
                spmd_run_pipeline_streaming(
                    mesh, fa, bam, spmd_prefix,
                    chunk_records=args.chunk_records, stages_out=stages,
                    log=lambda *a: print("#", *a, file=sys.stderr,
                                         flush=True))
                spmd_totals.append(round(time.time() - t0, 2))
            t_spmd = min(spmd_totals)

            ours = sv_rows(spmd_prefix + ".sv")
            parity = "exact" if ours == want else "MISMATCH"
            all_exact &= parity == "exact"
            peak_rss_mb = resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 1024
            result = {
                "metric": "stream_spmd_scale_run",
                "genome_mb": args.genome_mb, "coverage": args.coverage,
                "devices": nd, "mesh": dict(
                    zip(mesh.axis_names, mesh.devices.shape)),
                "chunk_records": args.chunk_records,
                "sv_parity_vs_sequential_stream": parity,
                "sv_rows": len(want),
                "sequential_stream_s": round(t_seq, 1),
                "spmd_stream_s": round(t_spmd, 1),
                "speedup_vs_sequential": round(t_seq / t_spmd, 3),
                "trials": max(1, args.trials),
                "seq_totals_s": seq_totals,
                "spmd_totals_s": spmd_totals,
                "spmd_stages_s": stages,
                "peak_rss_mb": round(peak_rss_mb, 1),
                "jax_platform": jax.devices()[0].platform,
                "note": ("virtual CPU mesh: validates composition memory "
                         "bound + exactness, not chip throughput"),
            }
            line = json.dumps(result)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    if not all_exact:
        sys.exit(1)


if __name__ == "__main__":
    main()
