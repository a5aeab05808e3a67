"""2-process jax.distributed multi-host simulation (SURVEY.md §4
implication / §2 communication call-out): host-sharded BAM ingest ->
jax.make_array_from_process_local_data -> the real coverage+insert-size
shard_map step, with NO process ever holding the whole file — asserted
equal to the sequential single-process result.

The workers run in separate python processes (tests/multihost_worker.py)
coordinated over a local TCP port with gloo CPU collectives; this is the
same initialization path a real multi-host GPU cluster uses
(jax.distributed.initialize), minus the hardware."""
import os
import socket
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "multihost_worker.py")
CANCER = "/root/reference/example/cancer.sort.bam"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(extra_args, ok_token, timeout=420, bam=CANCER, nproc=2):
    port = _free_port()
    env = dict(os.environ)
    # the workers pick their own platform/device config in-process
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(pid), str(nproc), str(port), bam]
        + extra_args,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        text=True) for pid in range(nproc)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
    assert ok_token in outs[0], outs[0][-3000:]
    return outs


def test_two_process_coverage_insert_equals_sequential():
    _run_workers([], "MULTIHOST_OK")


def test_two_process_full_pipeline_sv_byte_equal(tmp_path):
    """Host-sharded ingest -> per-process getclip -> junction-event
    all-gather -> partitioned merge -> multi-process coverage+insert ->
    chromosome-local discordant -> byte-equal sv.txt, with no process
    reading the whole BAM or clip table (VERDICT r2 item 4)."""
    _run_workers(
        ["pipeline", "/root/reference/example/reference/example.fa",
         str(tmp_path)], "MULTIHOST_PIPELINE_OK")


def test_two_process_somatic_byte_equal(tmp_path):
    """Distributed tumor/normal subtraction (VERDICT r3 #6): the normal
    BAM host-sharded, per-process local clip maps + discordant counting,
    per-row triples summed across processes — byte-equal temp AND final
    somatic.sv vs the sequential pass."""
    _run_workers(["somatic", "/root/reference/example/cancer.sv",
                  str(tmp_path)], "MULTIHOST_SOMATIC_OK",
                 bam="/root/reference/example/normal.sort.bam")


def _single_chrom_dataset(tmp_path, with_equal_boundary: bool):
    """Single-chromosome simulated dataset; optionally with two
    deletions whose downstream contexts are IDENTICAL and which straddle
    the 2-process flat cut (G/2) — the adjacent-equal-clipped-seq case
    the sequential co-iteration merges into one group (getsv.h:472-509)
    and the range sharding must exchange across the seam."""
    import numpy as np

    from seeksv_tpu.io.bai import build_index
    from seeksv_tpu.utils.simulate import (build_donor, random_genome,
                                           simulate_reads, write_fasta)
    rng = np.random.default_rng(3)
    G = 240_000
    g = random_genome(rng, G)
    dels = [(30_000, 30_400), (200_000, 200_500)]
    cov, seed = 30, 5
    if with_equal_boundary:
        # two deletions with IDENTICAL junction contexts either side of
        # the 2-process cut (G/2 = 120k); coverage 120 + seed 0 verified
        # to produce byte-equal adjacent clip consensi straddling it
        startA, endA = 117_000, 117_400
        startB, endB = 123_000, 123_400
        g[endB:endB + 300] = g[endA:endA + 300]
        g[startB - 300:startB] = g[startA - 300:startA]
        dels += [(startA, endA), (startB, endB)]
        cov, seed = 120, 0
    ref = {"chr1": g}
    donor = build_donor(ref, deletions=sorted(dels))
    bam = str(tmp_path / "sim.bam")
    fa = str(tmp_path / "ref.fa")
    simulate_reads(donor, ["chr1"], [G], bam, coverage=cov, seed=seed,
                   error_rate=0.0)
    build_index(bam)
    write_fasta(fa, ref)
    return bam, fa


def _tumor_normal_single_chrom(tmp_path):
    """Single-chromosome tumor/normal pair: two GERMLINE deletions (in
    both samples), one with its breakends ~10-400 bp below the 2-process
    flat cut (G/2 = 120k) so normal clip evidence sits within the
    somatic probe halo of a cut, plus two somatic-only deletions."""
    import numpy as np

    from seeksv_tpu.io.bai import build_index
    from seeksv_tpu.utils.simulate import (build_donor, random_genome,
                                           simulate_reads, write_fasta)
    rng = np.random.default_rng(11)
    G = 240_000
    g = random_genome(rng, G)
    ref = {"chr1": g}
    germline = [(40_000, 40_400), (119_600, 119_990)]
    somatic_only = [(80_000, 80_500), (170_000, 170_350)]
    fa = str(tmp_path / "ref.fa")
    write_fasta(fa, ref)
    cancer = str(tmp_path / "cancer.bam")
    donor_c = build_donor(ref, deletions=sorted(germline + somatic_only))
    simulate_reads(donor_c, ["chr1"], [G], cancer, coverage=30, seed=7,
                   error_rate=0.0)
    build_index(cancer)
    normal = str(tmp_path / "normal.bam")
    donor_n = build_donor(ref, deletions=sorted(germline))
    simulate_reads(donor_n, ["chr1"], [G], normal, coverage=30, seed=8,
                   error_rate=0.0)
    build_index(normal)
    return cancer, normal, fa


@pytest.mark.parametrize("nproc", [2, 4])
def test_range_sharded_somatic_single_chromosome(tmp_path, nproc):
    """Sub-chromosome range-sharded somatic (flat cuts land mid-chr1):
    byte-equal temp AND final somatic.sv vs the sequential pass, with
    normal clip evidence inside a cut's halo (the clip-line exchange
    must fire, not pass vacuously) and germline rows subtracted."""
    import io

    from seeksv_tpu.pipeline.driver import run_pipeline
    cancer, normal, fa = _tumor_normal_single_chrom(tmp_path)
    run_pipeline(fa, cancer, str(tmp_path / "cancer"),
                 filtered_out=io.StringIO())
    tumor_sv = str(tmp_path / "cancer.sv")
    outs = _run_workers(["somatic_range", tumor_sv, str(tmp_path)],
                        "MULTIHOST_SOMATIC_RANGE_OK", bam=normal,
                        nproc=nproc)
    joined = "".join(outs)
    assert "somatic clip halo" in joined, joined[-2000:]
    # germline rows must carry nonzero control columns -> filtered from
    # the final set; somatic-only rows survive
    final = open(tmp_path / "mpr.somatic.sv").read().splitlines()
    rows = [ln for ln in final if not ln.startswith("@")]
    poss = [int(r.split("\t")[1]) for r in rows]
    assert any(abs(p - 80_000) < 60 for p in poss), rows
    assert not any(abs(p - 119_600) < 60 for p in poss), rows


@pytest.mark.parametrize("nproc", [2, 4])
def test_range_sharding_single_chromosome(tmp_path, nproc):
    """VERDICT r3 #5 'Done': N-process byte-equal sv.txt on a
    SINGLE-chromosome genome (the flat-position cuts land mid-chr1)."""
    bam, fa = _single_chrom_dataset(tmp_path, with_equal_boundary=False)
    _run_workers(["pipeline", fa, str(tmp_path)],
                 "MULTIHOST_PIPELINE_OK", bam=bam, nproc=nproc)


def test_range_sharding_equal_boundary_group_exchange(tmp_path):
    """Adjacent clip groups with EQUAL clipped seqs straddling the
    process cut: the r3 form raised; the range sharding exchanges the
    boundary group and stays byte-equal to the sequential pass."""
    bam, fa = _single_chrom_dataset(tmp_path, with_equal_boundary=True)
    outs = _run_workers(["pipeline", fa, str(tmp_path)],
                        "MULTIHOST_PIPELINE_OK", bam=bam, nproc=2)
    # the exchange must actually FIRE (not pass vacuously)
    assert any("boundary-group exchange" in o for o in outs), outs[0][-2000:]
