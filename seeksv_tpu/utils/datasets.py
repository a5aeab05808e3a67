"""Simulated scale datasets shared by the benchmarks and chip_smoke.py,
and their truth-recall grading.  Everything is generated from a seed by
utils.simulate; nothing outside the repository is read."""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

# The long-fragment virus-integration workload: a 40 Mbp host contig at
# 25x of 1 kb reads, 30 DEL/INV events, and 6,000 integrations of
# segments of a 12 Mb virus panel whose integrated strain diverges by 4%.
VIRUS_LONG_FRAGMENT = dict(G=40_000_000, cov=25, read_len=1000, n_events=30,
                           virus_kb=12_000, virus_events=6_000,
                           virus_div=0.04)


def build_dataset(root, G, cov, read_len, seed, n_events, with_repeats,
                  virus_kb=0, virus_events=0, virus_div=0.04):
    """Simulate a truth-bearing scale dataset into `root`: ref.fa (one
    `chr17` contig of G bp, plus a `virus` contig of virus_kb kb when
    asked), sim.bam + sim.bam.bai (coordinate-sorted reads of read_len at
    coverage cov) and truth.json (DEL/INV events and, per virus
    integration, both host-virus junctions).  n_events DEL/INV events
    (65% DEL) and virus_events integrations of segments of a strain
    diverged by virus_div share one slot grid, so no two overlap.
    Deterministic in `seed`; a finished dataset (root/.done) is reused."""
    from seeksv_tpu.io.bai import build_index
    from seeksv_tpu.utils.simulate import (build_donor, mutate,
                                           random_genome, simulate_reads,
                                           write_fasta)
    os.makedirs(root, exist_ok=True)
    done = os.path.join(root, ".done")
    if os.path.exists(done):
        return
    rng = np.random.default_rng(seed)
    g = random_genome(rng, G)
    if with_repeats:
        for _ in range(max(1, G // 2_000_000)):
            src = int(rng.integers(0, G - 20_000))
            dst = int(rng.integers(0, G - 20_000))
            ln = int(rng.integers(2_000, 15_000))
            g[dst:dst + ln] = g[src:src + ln]
    ref = {"chr17": g}
    margin = 50_000
    # one global slot array so del/inv intervals and virus insertion
    # points never overlap (build_donor requires disjoint sorted events)
    n_slots = max(n_events + virus_events, 1)
    slots = np.linspace(margin, G - margin - 10_000, n_slots)
    spacing = (G - 2 * margin - 10_000) / n_slots
    max_ev_len = int(min(5_000, max(spacing - 1_000, 300)))
    kinds = np.array(["sv"] * n_events + ["virus"] * virus_events)
    rng.shuffle(kinds)
    dels, invs, inss = [], [], []
    vtruth = []
    if virus_kb:
        virus = random_genome(rng, virus_kb * 1000)
        ref["virus"] = virus
        # the donor's integrated strain diverges from the reference
        # contig (mutate docstring)
        vmut = mutate(rng, virus, virus_div)
        # each integration takes a DISJOINT slice of the panel when it is
        # big enough (a multi-virus integration panel): overlapping draws
        # make two host sites share virus sequence, which is a genuinely
        # ambiguous call the two pipelines may resolve differently —
        # disjoint slices keep the byte-parity contract checkable
        vblock = 2_000
        if virus_kb * 1000 >= virus_events * vblock + vblock:
            vstarts = rng.permutation(virus_kb * 1000 // vblock - 1)[
                :virus_events] * vblock
        else:
            vstarts = None
        vi = 0
    for p, kind in zip(slots, kinds):
        if kind == "sv":
            ln = int(rng.integers(200, max_ev_len))
            (dels if rng.random() < 0.65
             else invs).append((int(p), int(p) + ln))
        else:
            vlen = int(rng.integers(500, 2_000))
            if vstarts is not None:
                voff = int(vstarts[vi])
                vi += 1
            else:
                voff = int(rng.integers(0, len(vmut) - vlen))
            inss.append((int(p), vmut[voff:voff + vlen]))
            # left junction: chr17:p -> virus:voff(+) ; right junction:
            # virus:voff+vlen -> chr17:p+1 (1-based breakends as sv.txt)
            vtruth.append({"type": "VINT", "up_chrom": "chr17", "up": int(p),
                           "down_chrom": "virus", "down": voff + 1,
                           "right_up": voff + vlen,
                           "right_down": int(p) + 1})
    donor = build_donor(ref, deletions=dels, inversions=invs,
                        insertions=inss)
    with open(os.path.join(root, "truth.json"), "w") as f:
        json.dump([{"type": t[0], "up_chrom": t[1], "up": int(t[2]),
                    "down_chrom": t[3], "down": int(t[4])}
                   for t in donor.truth if t[0] != "INS"] + vtruth, f)
    insert_mean = max(500, 3 * read_len)
    t0 = time.time()
    simulate_reads(donor, list(ref), [len(ref[c]) for c in ref],
                   os.path.join(root, "sim.bam"),
                   coverage=cov, seed=seed, error_rate=0.002,
                   read_len=read_len, insert_mean=insert_mean)
    build_index(os.path.join(root, "sim.bam"))
    write_fasta(os.path.join(root, "ref.fa"), ref)
    print(f"# simulated {G / 1e6:.0f}Mbp x {cov}x ({len(dels)} DEL, "
          f"{len(invs)} INV) in {time.time() - t0:.1f}s", file=sys.stderr)
    open(done, "w").close()


def build_workload(root, seed, w=VIRUS_LONG_FRAGMENT):
    """build_dataset for a workload dict (keys as VIRUS_LONG_FRAGMENT)."""
    build_dataset(root, w["G"], w["cov"], w["read_len"], seed,
                  w["n_events"], False, virus_kb=w["virus_kb"],
                  virus_events=w["virus_events"], virus_div=w["virus_div"])


def sv_recall(truth, rows):
    """(del_recall, virus_junction_recall) of an sv.txt row list against
    the embedded truth; +-50bp fuzzy match, the reference's own
    comparison window (svcompare.cpp:330 MergeNear) — microhomology
    shifts both breakends under the default -l 50 merge.  Virus
    integrations contribute two junctions each (host->virus and
    virus->host)."""
    calls = []
    for r in rows:
        fl = r.split("\t")
        calls.append((fl[0], int(fl[1]), fl[4], int(fl[5])))
    cu = np.asarray([c[1] for c in calls], np.int64)
    cd = np.asarray([c[3] for c in calls], np.int64)

    def hit(up_chrom, up, down_chrom, down):
        m = (np.abs(cu - up) <= 50) & (np.abs(cd - down) <= 50)
        return any(m[i] and calls[i][0] == up_chrom
                   and calls[i][2] == down_chrom
                   for i in np.nonzero(m)[0])

    dels = [t for t in truth if t["type"] == "DEL"]
    dr = round(sum(hit(t["up_chrom"], t["up"], t["down_chrom"], t["down"])
                   for t in dels) / max(len(dels), 1), 4)
    vints = [t for t in truth if t["type"] == "VINT"]
    vr = None
    if vints:
        vhit = 0
        for t in vints:
            vhit += hit(t["up_chrom"], t["up"], t["down_chrom"], t["down"])
            vhit += hit(t["down_chrom"], t["right_up"],
                        t["up_chrom"], t["right_down"])
        vr = round(vhit / (2 * len(vints)), 4)
    return dr, vr
