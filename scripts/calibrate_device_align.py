"""Calibrate the fully device-resident realignment front-end
(ops/align_device.py, `run --device-align`) against the host front-end,
so `--device-align-auto` enables it only where it wins.

Measured on the attached card:
  1. index upload cost: the one-time device residency price of the
     k-mer index (keys + positions + reference), with block_until_ready;
  2. per-chunk alignment wall: DeviceAligner.align_jobs vs the host
     front-end (batch seeding + native extension) on identical read
     batches;
  3. the break-even chunk count: setup_s / (host_per_chunk -
     device_per_chunk) when the device wins per chunk, else "never".

The reference is a random genome simulated from --seed (per-chunk
throughput is index-size independent: seeding is a bounded binary
search, extension windows are local).

Output: seeksv_tpu/align/device_align_calibration.json (committed
artifact; `--device-align-auto` consults it), with the card's
device_kind and its nvidia-smi name and power limit.

Usage: python scripts/calibrate_device_align.py [--out PATH] [--genome-mb 8]
"""
import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CHUNKS = [256, 1024, 4096]
READ_LEN = 60


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "seeksv_tpu", "align", "device_align_calibration.json"))
    ap.add_argument("--genome-mb", type=float, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    from calibrate_dispatch import nvidia_smi
    from seeksv_tpu.align.engine import BatchAligner
    from seeksv_tpu.ops.align_device import DeviceAligner
    from seeksv_tpu.utils.simulate import random_genome, write_fasta

    dev = jax.devices()[0]
    rng = np.random.default_rng(args.seed)
    with tempfile.TemporaryDirectory() as d:
        fa = os.path.join(d, "ref.fa")
        write_fasta(fa, {"chrS": random_genome(
            rng, int(args.genome_mb * 1e6))})
        host_al = BatchAligner.from_fasta(fa, cache=False)

        # 1. index upload, waited for on the device
        idx = host_al.idx
        t0 = time.perf_counter()
        for a in (idx.keys, idx.positions, idx.ref):
            jax.device_put(np.asarray(a)).block_until_ready()
        upload_s = time.perf_counter() - t0
        idx_bytes = int(idx.keys.nbytes + idx.positions.nbytes
                        + idx.ref.nbytes)

        # 2. per-chunk wall: device front-end vs host front-end
        ref_codes = np.asarray(idx.ref)
        rows = []
        dev_al = DeviceAligner(idx)
        for B in CHUNKS:
            starts = rng.integers(0, len(ref_codes) - READ_LEN, B)
            reads = [np.asarray(ref_codes[s:s + READ_LEN], np.uint8).copy()
                     for s in starts]
            # sprinkle mismatches so extension does work
            for r in reads:
                m = rng.random(len(r)) < 0.02
                r[m] = (r[m] + 1) % 4
            seqs = [bytes(b"ACGT"[c] for c in r) for r in reads]

            t0 = time.perf_counter()
            dev_al.align_jobs(reads)
            warm = time.perf_counter() - t0
            t0 = time.perf_counter()
            out = dev_al.align_jobs(reads)
            device_s = time.perf_counter() - t0

            t0 = time.perf_counter()
            host_al.batch_align(seqs, force_host=True)
            host_s = time.perf_counter() - t0
            rows.append({"chunk_reads": B, "device_s": device_s,
                         "device_warmup_s": warm, "host_s": host_s,
                         "device_wins_per_chunk": device_s < host_s,
                         "overflowed": out is None})
            print(json.dumps(rows[-1]), file=sys.stderr)

    # 3. break-even
    best = min(rows, key=lambda r: r["device_s"] / max(r["host_s"], 1e-9))
    if best["device_s"] < best["host_s"]:
        be_chunks = upload_s / (best["host_s"] - best["device_s"])
        break_even = {"chunks": round(be_chunks, 1),
                      "at_chunk_reads": best["chunk_reads"]}
    else:
        break_even = "never-at-measured-sizes"

    result = {
        "device_kind": dev.device_kind, "platform": dev.platform,
        "nvidia_smi": nvidia_smi() if dev.platform == "gpu" else None,
        "genome_mb": args.genome_mb,
        "index_bytes": idx_bytes,
        "index_upload_s": upload_s,
        "rows": rows,
        "break_even": break_even,
        "note": ("per-chunk throughput is index-size independent; "
                 "index_upload_s is the one-time residency cost"),
    }
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"break_even": break_even,
                      "index_upload_s": upload_s, "out": args.out}))


if __name__ == "__main__":
    main()
