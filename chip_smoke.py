"""Smoke run of seeksv-tpu on one NVIDIA GPU: every device kernel of the
realignment path, compiled for the card and compared with its plain
reference, and the full pipeline on a simulated long-fragment
virus-integration workload.

Phases (each prints one JSON line; any failure raises, exit code != 0):
  a  environment: JAX version, platform, device kind and count, and the
     card's name and power limit from nvidia-smi; fails unless the
     platform is "gpu".
  b  extension DP: the chosen kernel (ops.extend) against the threaded
     C++ host kernel, exact on all five outputs, at the calibration shape
     (LQ=128, LT=256, B in 4k/16k/64k) and the virus shape (LQ=1024,
     LT=1536, B=18,143, 4% divergence), through plain windows and through
     the resident-reference gather; times the kernel and XLA's scan.
  c  finalize: DeviceGlobalAligner on the card against the host ladder
     (score, CIGAR, NM identical) for 600-1,100 bp jobs at 1% and 4%
     divergence; times the rung-16 and rung-64 direction passes, the walk
     per step, and device-alone finalize against the host ladder.
  d  main path: the 40 Mbp / 25x / 1 kb-read workload with 6,000 virus
     integrations at 4% divergence, simulated from --seed, through
     pipeline.driver.run_pipeline (what `seeksv-tpu run` calls); the
     dispatch must choose the device for extension; a host-pinned arm in
     the same process must give byte-identical sv and clip.sam; truth
     recall of DELs and virus junctions must reach 0.99.
  e  device front-ends: phase d's clip fastq realigned with device_seed
     and with device_align; each clip.sam byte-identical to phase d's.
  f  (--four-cards only, and then alone) the SPMD pipeline on a 4-card
     mesh with device extension forced, against the single-card
     sequential run: sv and clip.gz byte-equal.

The last line of standard output is
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Usage: python chip_smoke.py [--seed 1] [--four-cards]
"""
import argparse
import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

# a GPU run must not fall back to the CPU quietly
os.environ.setdefault("JAX_PLATFORMS", "cuda")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from seeksv_tpu.io import native  # noqa: E402
from seeksv_tpu.ops import extend as ext  # noqa: E402
from seeksv_tpu.ops.jax_kernels import sw_extend_batch  # noqa: E402
from seeksv_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402
from seeksv_tpu.utils.datasets import (VIRUS_LONG_FRAGMENT,  # noqa: E402
                                       build_workload, sv_recall)

import jax  # noqa: E402

OUTS = ("max_score", "qle", "tle", "gscore", "gtle")
EXTEND_CASES = [  # (LQ, LT, B, divergence, reverse)
    (128, 256, 4096, 0.05, False),
    (128, 256, 16384, 0.05, True),
    (128, 256, 65536, 0.05, False),
    (1024, 1536, 18143, 0.04, False),
]


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def best_of(fn, trials):
    """(result, best wall seconds) of fn(); fn returns host arrays."""
    out, best = None, None
    for _ in range(trials):
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return out, best


def host(d):
    return {k: np.asarray(d[k]).astype(np.int64) for k in OUTS}


# ---- a ---------------------------------------------------------------------

def phase_env(n_cards):
    cache = configure_compile_cache()
    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SystemExit(f"platform {d.platform!r} is not a GPU")
    if len(devs) < n_cards:
        raise SystemExit(f"{len(devs)} GPUs visible, {n_cards} needed")
    if not native.sw_available():
        raise SystemExit("the native host kernels (csrc) failed to build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit("env", jax=jax.__version__, platform=d.platform,
         device_kind=d.device_kind, count=len(devs),
         nvidia_smi=smi.splitlines(), compile_cache=cache)
    return d, smi.splitlines()[0]


# ---- b ---------------------------------------------------------------------

def make_jobs(rng, genome, B, LQ, LT, div, reverse):
    """Extension jobs shaped as the engine builds them: each target is a
    reference window (walked backwards for left extensions) of qlen+100
    codes; each query copies its window at `div` substitutions, and half
    of them turn random past a break (a junction), which z-drops."""
    G = len(genome)
    ql = rng.integers(LQ // 4, LQ + 1, B).astype(np.int32)
    tl = np.minimum(ql + 100, LT).astype(np.int32)
    cols = np.arange(LT)
    if reverse:
        start = rng.integers(LT, G, B).astype(np.int32)
        idx = start[:, None] - cols
    else:
        start = rng.integers(0, G - LT, B).astype(np.int32)
        idx = start[:, None] + cols
    t = np.where(cols < tl[:, None], genome[idx], 4).astype(np.int8)
    q = t[:, :LQ].copy()
    mut = rng.random((B, LQ)) < div
    q[mut] = (q[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
    brk = np.where(rng.random(B) < 0.5,
                   (ql * rng.uniform(0.3, 1.0, B)).astype(np.int32), ql)
    qc = np.arange(LQ)
    junk = qc >= brk[:, None]
    q[junk] = rng.integers(0, 4, int(junk.sum()))
    q[qc >= ql[:, None]] = 4
    h0 = rng.integers(19, 60, B).astype(np.int32)
    return q, ql, t, tl, h0, start


def phase_extend(cases=EXTEND_CASES, trials=3, seed=0):
    plat = ext.platform()
    kern = ext.extend_kernel(plat)
    rng = np.random.default_rng(seed)
    G = 1 << 24
    genome = rng.integers(0, 4, G).astype(np.uint8)
    genome[rng.random(G) < 0.001] = 4
    refp = jax.device_put(ext.pack_nibbles(genome[None, :])[0])
    for LQ, LT, B, div, reverse in cases:
        q, ql, t, tl, h0, start = make_jobs(rng, genome, B, LQ, LT, div,
                                            reverse)
        cells = int((ql.astype(np.int64) * tl).sum())
        want, native_s = best_of(lambda: native.sw_extend_batch_native(
            q, ql, t, tl, h0), 1)
        q4 = ext.pack_nibbles(q.view(np.uint8))
        arms = {
            "kernel": lambda: host(kern(q, ql, t, tl, h0)),
            "kernel_resident": lambda: host(ext.extend_resident(
                kern, q4, ql, start, tl, h0, refp, G, LQ, LT, reverse)),
            "xla": lambda: host(sw_extend_batch(q, ql, t, tl, h0)),
        }
        row = {"LQ": LQ, "LT": LT, "B": B, "divergence": div,
               "reverse": reverse, "cells": cells, "kernel": plat,
               "native_s": native_s}
        bad = []
        for name, fn in arms.items():
            t0 = time.perf_counter()
            fn()                                   # compile + warm
            row[f"{name}_first_s"] = time.perf_counter() - t0
            got, row[f"{name}_s"] = best_of(fn, trials)
            row[f"{name}_gcells_s"] = cells / row[f"{name}_s"] / 1e9
            bad += [f"{name}.{k}" for k in OUTS
                    if not np.array_equal(got[k], want[k])]
        row["exact"] = not bad
        emit("extend", **row)
        if bad:
            raise AssertionError(f"extension mismatch vs host kernel: {bad}")


# ---- c ---------------------------------------------------------------------

def _mutate(rng, q, sub, indel):
    """q with substitutions at rate `sub` and 1-3 bp indels at `indel`."""
    out, i = [], 0
    while i < len(q):
        r = rng.random()
        if r < indel / 2:
            i += int(rng.integers(1, 4))           # deletion
            continue
        if r < indel:
            out.extend(rng.integers(0, 4, int(rng.integers(1, 4))))
        b = int(q[i])
        out.append((b + int(rng.integers(1, 4))) % 4
                   if rng.random() < sub else b)
        i += 1
    return np.asarray(out, np.uint8)


def finalize_jobs(rng, n, div):
    qs, ts = [], []
    for _ in range(n):
        t = rng.integers(0, 4, int(rng.integers(600, 1101))).astype(np.uint8)
        qs.append(_mutate(rng, t, div, div / 10))
        ts.append(t)
    return qs, ts


def _time_device(fn, trials=3):
    def run():
        return jax.block_until_ready(fn())
    run()
    return best_of(run, trials)


def phase_finalize(n_per=2048, seed=0):
    from seeksv_tpu.ops import global_device as gd
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for div in (0.01, 0.04):
        a, b = finalize_jobs(rng, n_per, div)
        qs += a
        ts += b
    dga = gd.DeviceGlobalAligner()
    dga.align_batch(qs[:256], ts[:256])            # compile
    got, dev_s = best_of(lambda: dga.align_batch(qs, ts), 2)
    want, host_s = best_of(lambda: native.sw_global_batch_native(qs, ts), 2)
    bad = [i for i, v in got.items()
           if (v[0], v[1], v[2]) != tuple(want[i])]
    # per-pass device times at the jobs' common bucket
    B = len(qs)
    ms = np.asarray([len(x) for x in qs], np.int32)
    ns = np.asarray([len(x) for x in ts], np.int32)
    LQ = dga._bucket(int(ms.max()), dga.LQ_BUCKETS)
    LT = dga._bucket(int(ns.max()), dga.LQ_BUCKETS)
    q = np.full((B, LQ), 4, np.uint8)
    t = np.full((B, LT), 4, np.uint8)
    for r in range(B):
        q[r, :ms[r]] = qs[r]
        t[r, :ns[r]] = ts[r]
    qd, td, md, nd = (jax.device_put(x) for x in (q, t, ms, ns))
    passes = {}
    for w, K in dga.RUNGS:
        Bc = min(B, max(128, dga.max_dir_bytes // (LQ * K)))
        dlo = jax.device_put((np.minimum(0, ns - ms) - w).astype(np.int32))
        t2 = gd.build_t2(td, nd, dlo, K=K, LQ=LQ, LT=LT)
        args = (qd[:Bc], md[:Bc], t2[:Bc], dlo[:Bc], nd[:Bc])
        (sc, dirs), dir_s = _time_device(
            lambda: gd.banded_direction(*args, K=K, LQ=LQ))
        T = LQ + K
        _, walk_s = _time_device(lambda: gd.traceback_rle(
            dirs, args[0], args[2], args[1], args[4], args[3],
            K=K, LQ=LQ, T=T))
        passes[f"rung{w}"] = {
            "jobs": Bc, "K": K, "LQ": LQ, "direction_s": dir_s,
            "direction_gcells_s": Bc * LQ * K / dir_s / 1e9,
            "walk_s": walk_s, "walk_steps": T, "walk_s_per_step": walk_s / T}
    emit("finalize", jobs=B, accepted=len(got), mismatches=len(bad),
         device_alone_s=dev_s, host_ladder_s=host_s, passes=passes)
    if bad:
        raise AssertionError(f"finalize mismatch vs host ladder: {bad[:5]}")
    if len(got) < B // 2:
        raise AssertionError(f"device accepted only {len(got)} of {B} jobs")


# ---- d, e ------------------------------------------------------------------

def sv_rows(path):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("@")]


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def dataset(root, seed, w=VIRUS_LONG_FRAGMENT):
    t0 = time.perf_counter()
    build_workload(root, seed, w)
    return time.perf_counter() - t0


def phase_main(root, out, min_recall=0.99):
    from seeksv_tpu.align.engine import BatchAligner
    from seeksv_tpu.pipeline.driver import run_pipeline
    ref, bam = os.path.join(root, "ref.fa"), os.path.join(root, "sim.bam")
    t0 = time.perf_counter()
    BatchAligner.from_fasta(ref)                   # k-mer index, cached
    index_s = time.perf_counter() - t0
    log = lambda *a: print("#", *a, file=sys.stderr)  # noqa: E731
    BatchAligner.check_calibration(log=log)
    arms = {}
    for name, force_host in (("device", False), ("host", True)):
        t0 = time.perf_counter()
        st = run_pipeline(ref, bam, os.path.join(out, name),
                          force_host=force_host, log=log)
        arms[name] = dict(st, wall_s=time.perf_counter() - t0)
    dispatch = arms["device"]["dispatch"]
    with open(os.path.join(root, "truth.json")) as f:
        truth = json.load(f)
    del_recall, virus_recall = sv_recall(
        truth, sv_rows(os.path.join(out, "device.sv")))
    sv_same = _same_bytes(os.path.join(out, "device.sv"),
                          os.path.join(out, "host.sv"))
    sam_same = _same_bytes(os.path.join(out, "device.clip.sam"),
                           os.path.join(out, "host.clip.sam"))
    emit("main", index_s=index_s, arms=arms, sv_identical=sv_same,
         clip_sam_identical=sam_same, del_recall=del_recall,
         virus_junction_recall=virus_recall)
    if not (dispatch and dispatch["chose_device"]):
        raise AssertionError(f"dispatch did not choose the device: {dispatch}")
    if not (sv_same and sam_same):
        raise AssertionError("device and host arms differ")
    if del_recall < min_recall or (virus_recall or 0) < min_recall:
        raise AssertionError(f"truth recall {del_recall}/{virus_recall}")


def phase_front_ends(root, out):
    from seeksv_tpu.pipeline.driver import realign_clips
    ref = os.path.join(root, "ref.fa")
    fq = os.path.join(out, "device.clip.fq.gz")
    want = os.path.join(out, "device.clip.sam")
    rows = {}
    for mode in ("device_seed", "device_align"):
        sam = os.path.join(out, f"{mode}.clip.sam")
        t0 = time.perf_counter()
        al = realign_clips(ref, fq, sam, **{mode: True})
        rows[mode] = {"wall_s": time.perf_counter() - t0,
                      "timings": al.timings,
                      "declined_batches": al.device_front_end_declined,
                      "identical": _same_bytes(sam, want)}
    emit("front_ends", **rows)
    bad = [m for m, r in rows.items() if not r["identical"]]
    if bad:
        raise AssertionError(f"clip.sam differs with {bad}")


# ---- f ---------------------------------------------------------------------

def phase_four_cards(root, out, n=4):
    from seeksv_tpu.parallel import make_mesh
    from seeksv_tpu.parallel.spmd_pipeline import spmd_run_pipeline
    from seeksv_tpu.pipeline.driver import run_pipeline
    ref, bam = os.path.join(root, "ref.fa"), os.path.join(root, "sim.bam")
    mesh = make_mesh(n)
    t0 = time.perf_counter()
    spmd_run_pipeline(mesh, ref, bam, os.path.join(out, "spmd"),
                      force_device_extend=True)
    spmd_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_pipeline(ref, bam, os.path.join(out, "seq"))
    seq_s = time.perf_counter() - t0
    sv_same = _same_bytes(os.path.join(out, "spmd.sv"),
                          os.path.join(out, "seq.sv"))
    clip = [gzip.open(os.path.join(out, f"{p}.clip.gz")).read()
            for p in ("spmd", "seq")]
    emit("four_cards", mesh=dict(mesh.shape), spmd_s=spmd_s,
         sequential_s=seq_s, sv_identical=sv_same,
         clip_gz_identical=clip[0] == clip[1],
         sv_rows=len(sv_rows(os.path.join(out, "seq.sv"))))
    if not (sv_same and clip[0] == clip[1]):
        raise AssertionError("SPMD run differs from the sequential run")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1,
                    help="seed of the simulated workload")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card SPMD phase (f)")
    args = ap.parse_args()
    n_cards = 4 if args.four_cards else 1
    dev, smi = phase_env(n_cards)
    work = tempfile.mkdtemp(prefix="seeksv_smoke_")
    try:
        root = os.path.join(work, "data")
        out = os.path.join(work, "out")
        os.makedirs(out)
        if not args.four_cards:
            phase_extend()
            phase_finalize()
        emit("dataset", workload=VIRUS_LONG_FRAGMENT, seed=args.seed,
             build_s=dataset(root, args.seed))
        if args.four_cards:
            phase_four_cards(root, out)
        else:
            phase_main(root, out)
            phase_front_ends(root, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
