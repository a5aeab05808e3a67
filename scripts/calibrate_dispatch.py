"""Measure the host-vs-device dispatch crossover for the batched
extension kernel and write it as a committed calibration artifact.

The engine's fallback is a blunt MIN_DEVICE_CELLS = 50M cliff
(align/engine.py).  This script replaces it with a measurement on the
actual hardware pair in play: the native C++ kernel (csrc) on this host
vs the kernel ops.extend chooses on the attached card (including the
host->device upload and device->host copy of every batch).

For each batch size it times both paths on identical random extension
workloads (LQ=128, LT=256 — the realignment engine's dominant bucket for
100-150bp reads) and reports cells/s; the crossover is interpolated where
the device first wins.  Output: seeksv_tpu/align/dispatch_calibration.json
(engine reads it at import; falls back to the old constant when absent).

The card's device_kind is the fingerprint the engine compares
(BatchAligner.calibration_stale); its nvidia-smi name and power limit
are recorded beside the rows.

Usage: python scripts/calibrate_dispatch.py [--out PATH]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LQ, LT = 128, 256
BATCHES = [64, 256, 1024, 4096, 16384, 65536]
# synthetic genome backing the device-resident target gather (the
# engine's single-chip path: nibble-packed queries, no target upload)
GENOME_MB = 64


def make_batch(rng, B, genome):
    # Realistic job mixture (matters for the host/device crossover): real
    # extension jobs have variable lengths inside the padded bucket (the
    # host kernel's cost scales with ACTUAL qlen*tlen; the device pays the
    # padded shape), and targets that are genome windows matching the
    # query up to a random break then diverging — which triggers the host
    # kernel's zdrop early exit exactly as clip-fragment extensions past
    # the junction do in production.  Targets are expanded host-side for
    # the host kernel and gathered device-side from the resident packed
    # genome for the device kernel — identical work on both paths.
    G = len(genome)
    ql = rng.integers(LQ // 4, LQ + 1, B).astype(np.int32)
    tl = np.minimum(ql + 100, LT).astype(np.int32)
    start = rng.integers(0, G - LT - 1, B).astype(np.int32)
    t = np.full((B, LT), 4, np.int8)
    q = np.full((B, LQ), 4, np.int8)
    brk = (ql * rng.uniform(0.3, 1.0, B)).astype(np.int32)
    for b in range(B):
        w = genome[start[b]:start[b] + tl[b]]
        t[b, :tl[b]] = w
        n = int(brk[b])
        qc = rng.integers(0, 4, ql[b]).astype(np.int8)
        m = rng.random(n) < 0.95
        qc[:n][m] = w[:n][m]       # query matches window up to the break
        q[b, :ql[b]] = qc
    h0 = np.full(B, 19, np.int32)
    return q, ql, t, tl, h0, start


def batch_cells(batch):
    _q, ql, _t, tl, _h0, _start = batch
    return int((ql.astype(np.int64) * tl).sum())


def time_host(batch, trials=3):
    from seeksv_tpu.io import native
    if not native.sw_available():
        return None
    q, ql, t, tl, h0, _start = batch
    best = None
    for _ in range(trials):
        t0 = time.perf_counter()
        native.sw_extend_batch_native(q, ql, t, tl, h0)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best


def time_device(batch, refp_dev, n_codes, trials=3):
    """Best wall seconds of the engine's device path, from host numpy to
    host results: on CPU XLA's scan on expanded windows, on a card the
    chosen kernel on nibble-packed queries with targets gathered from the
    resident reference."""
    from seeksv_tpu.ops import extend as ext

    q, ql, t, tl, h0, start = batch
    kern = ext.extend_kernel(ext.platform())
    if not ext.on_accelerator():
        def run():
            return kern(q, ql, t, tl, h0)
    else:
        q4 = ext.pack_nibbles(q.view(np.uint8))

        def run():
            return ext.extend_resident(kern, q4, ql, start, tl, h0,
                                       refp_dev, n_codes, LQ, LT, False)
    np.asarray(run()["max_score"])   # compile
    best = None
    for _ in range(trials):
        t0 = time.perf_counter()
        [np.asarray(v) for v in run().values()]
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best


def nvidia_smi():
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "seeksv_tpu", "align", "dispatch_calibration.json"))
    args = ap.parse_args()

    import jax

    from seeksv_tpu.ops.extend import pack_nibbles
    dev = jax.devices()[0]

    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, GENOME_MB << 20).astype(np.uint8)
    n_codes = len(genome)
    refp_dev = jax.device_put(pack_nibbles(genome[None, :])[0])
    refp_dev.block_until_ready()   # the one-time resident upload
    rows = []
    crossover_cells = None
    for B in BATCHES:
        batch = make_batch(rng, B, genome)
        cells = batch_cells(batch)  # ACTUAL cells, the engine's dispatch metric
        th = time_host(batch)
        td = time_device(batch, refp_dev, n_codes)
        row = {"batch": B, "cells": cells,
               "host_s": round(th, 5) if th else None,
               "device_s": round(td, 5) if td else None,
               "host_gcells_s": round(cells / th / 1e9, 3) if th else None,
               "device_gcells_s": round(cells / td / 1e9, 3) if td else None}
        rows.append(row)
        print(json.dumps(row), file=sys.stderr)
        if th and td and td < th and crossover_cells is None:
            if len(rows) > 1 and rows[-2]["host_s"] and rows[-2]["device_s"]:
                # log-interpolate between the last host-winning size and
                # this device-winning size
                prev = rows[-2]
                r0 = prev["device_s"] / prev["host_s"]
                r1 = td / th
                # find f in [0,1] with ratio crossing 1 (geometric)
                import math
                f = (math.log(r0) / (math.log(r0) - math.log(r1))
                     if r0 > 0 and r1 > 0 and r0 != r1 else 0.5)
                crossover_cells = int(prev["cells"] *
                                      (cells / prev["cells"]) ** f)
            else:
                crossover_cells = cells
    if crossover_cells is None and rows and rows[-1]["device_s"]:
        # device never won up to the largest size: place the crossover one
        # extrapolated octave beyond what was measured so the host path
        # keeps serving everything actually observed
        crossover_cells = rows[-1]["cells"] * 4

    out = {
        "kernel": "sw_extend_batch",
        "shape": {"LQ": LQ, "LT": LT},
        "host_threads": os.cpu_count(),
        "rows": rows,
        "crossover_cells": crossover_cells,
        # a run on another card must not trust this crossover:
        # engine.calibration_stale() compares device_kind
        "fingerprint": {"device_kind": dev.device_kind,
                        "platform": dev.platform,
                        "nvidia_smi": (nvidia_smi() if dev.platform == "gpu"
                                       else None)},
        "note": ("device path = nibble-packed query upload + resident-ref "
                 "target gather + one copy back per batch; crossover "
                 "measured end-to-end from host numpy inputs"),
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"crossover_cells": crossover_cells,
                      "device_kind": dev.device_kind, "out": args.out}))


if __name__ == "__main__":
    main()
