"""Measure the finalize stage's host/device split on the long-fragment
virus-integration workload (utils.datasets.VIRUS_LONG_FRAGMENT, the
workload chip_smoke.py runs).

The engine hands a share of the device-eligible finalize jobs to the
device (ops.global_device) and runs the host ladder on the rest
concurrently (BatchAligner._device_finalize_plan).  For each share this
realigns the workload's clip fastq and reports the finalize stage's wall
seconds and the device thread's seconds; every share must give the same
clip.sam bytes.  Trials interleave the shares.

Prints one JSON line per run, then a summary line with the best
finalize seconds per share and the card's nvidia-smi name and power
limit.

Usage: python scripts/calibrate_finalize_share.py [--seed 1] [--trials 2]
       [--shares 0,0.25,0.55,0.75,1]
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--trials", type=int, default=2)
    ap.add_argument("--shares", default="0,0.25,0.55,0.75,1")
    args = ap.parse_args()
    shares = [float(x) for x in args.shares.split(",")]

    import jax

    from calibrate_dispatch import nvidia_smi
    from seeksv_tpu.align.engine import BatchAligner
    from seeksv_tpu.pipeline.driver import realign_clips
    from seeksv_tpu.pipeline.getclip import getclip
    from seeksv_tpu.utils.datasets import VIRUS_LONG_FRAGMENT, build_workload

    dev = jax.devices()[0]
    work = tempfile.mkdtemp(prefix="seeksv_share_")
    try:
        root = os.path.join(work, "data")
        build_workload(root, args.seed)
        ref = os.path.join(root, "ref.fa")
        prefix = os.path.join(work, "clip")
        getclip(os.path.join(root, "sim.bam"), prefix)
        BatchAligner.from_fasta(ref)               # k-mer index, cached
        best, sams = {}, {}
        for trial in range(args.trials):
            for share in shares:
                os.environ["SEEKSV_TPU_FINALIZE_DEVICE_SHARE"] = str(share)
                sam = os.path.join(work, f"s{share}.sam")
                t0 = time.perf_counter()
                al = realign_clips(ref, f"{prefix}.clip.fq.gz", sam)
                row = {"share": share, "trial": trial,
                       "realign_s": time.perf_counter() - t0,
                       "finalize_s": al.timings["finalize_s"],
                       "device_finalize_s": al.timings["device_finalize_s"],
                       "split": al.last_finalize}
                print(json.dumps(row), flush=True)
                with open(sam, "rb") as f:
                    sams.setdefault(share, f.read())
                b = best.get(share)
                best[share] = (row["finalize_s"] if b is None
                               else min(b, row["finalize_s"]))
        identical = len(set(sams.values())) == 1
        print(json.dumps({
            "summary": "finalize_share", "workload": VIRUS_LONG_FRAGMENT,
            "seed": args.seed, "device_kind": dev.device_kind,
            "nvidia_smi": nvidia_smi() if dev.platform == "gpu" else None,
            "best_finalize_s": best, "clip_sam_identical": identical}))
        if not identical:
            sys.exit(1)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
