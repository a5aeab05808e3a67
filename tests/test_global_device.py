"""Device-side banded global finalize == host ladder, bit-identical.

The device path (ops/global_device.py) must reproduce the native
ladder's score, CIGAR and NM exactly for every job it accepts; jobs it
declines (decision past rung 64, run overflow, shape limits) fall back
to the host, so correctness only requires equality on the accepted
set plus the guarantee that acceptance decisions mirror the ladder's
first two steps (same scores in, same rules)."""
import numpy as np
import pytest

from seeksv_tpu.align.sw import global_align_np
from seeksv_tpu.ops.global_device import (DeviceGlobalAligner, MATCH,
                                          GAP_OPEN, GAP_EXT)


def _mutate(rng, q, sub_rate, indel_rate):
    t = []
    for b in q:
        r = rng.random()
        if r < indel_rate / 2:
            continue                       # deletion in target
        if r < indel_rate:
            t.append(int(rng.integers(0, 4)))   # insertion
        if rng.random() < sub_rate:
            t.append(int((b + 1 + rng.integers(0, 3)) % 4))
        else:
            t.append(int(b))
    return np.asarray(t, np.uint8)


def _cases(seed=7, n_cases=24):
    rng = np.random.default_rng(seed)
    cases = []
    for i in range(n_cases):
        m = int(rng.integers(260, 1400))
        q = rng.integers(0, 4, m).astype(np.uint8)
        sub = float(rng.choice([0.0, 0.005, 0.02, 0.05, 0.1]))
        ind = float(rng.choice([0.0, 0.002, 0.01, 0.03]))
        t = _mutate(rng, q, sub, ind)
        if len(t) <= 256:
            continue
        # some ambiguous bases
        if rng.random() < 0.3:
            t = t.copy()
            t[rng.integers(0, len(t), 5)] = 4
        cases.append((q, t))
    # adversarial shapes: pure diagonal, long deletions near band edges
    q = rng.integers(0, 4, 512).astype(np.uint8)
    cases.append((q, q.copy()))
    t = np.concatenate([q[:200], q[260:]])       # 60bp deletion
    cases.append((q, t))
    t = np.concatenate([q[:300], rng.integers(0, 4, 90).astype(np.uint8),
                        q[300:]])                # 90bp insertion
    cases.append((q, t))
    return cases


def test_device_global_matches_host_ladder():
    cases = _cases()
    qs = [c[0] for c in cases]
    ts = [c[1] for c in cases]
    dev = DeviceGlobalAligner()
    got = dev.align_batch(qs, ts)
    assert got, "no case accepted on device — fuzz set is vacuous"
    n_checked = 0
    for i, (sc, cig, nm) in got.items():
        ref_sc, ref_cig = global_align_np(qs[i], ts[i])
        assert sc == ref_sc, f"case {i}: score {sc} != {ref_sc}"
        assert cig == ref_cig, f"case {i}: cigar {cig} != {ref_cig}"
        # NM oracle: engine contract (mismatches on M + indel bases)
        qi = ti = mm = 0
        for ln, op in ref_cig:
            if op == "M":
                mm += int(np.sum(qs[i][qi:qi + ln] != ts[i][ti:ti + ln]))
                qi += ln
                ti += ln
            elif op == "I":
                mm += ln
                qi += ln
            else:
                mm += ln
                ti += ln
        assert nm == mm, f"case {i}: nm {nm} != {mm}"
        n_checked += 1
    # the low/mid-divergence bulk must be device-accepted (the whole
    # point of the kernel); high-divergence cases may fall back
    assert n_checked >= len(cases) // 2


def test_device_acceptance_mirrors_ladder_rules():
    """When the device declines a job, the host ladder's first two
    acceptance steps must also decline it (identical scores + rules),
    so no job is ever resolved by two different deciders."""
    from seeksv_tpu.align.sw import _global_banded_np
    cases = _cases(seed=11, n_cases=12)
    qs = [c[0] for c in cases]
    ts = [c[1] for c in cases]
    dev = DeviceGlobalAligner()
    got = dev.align_batch(qs, ts)
    for i, (q, t) in enumerate(cases):
        if not dev.eligible(len(q), len(t)):
            continue
        mn, ad = min(len(q), len(t)), abs(len(q) - len(t))
        sc16 = _global_banded_np(q, t, 16)[0]
        sc64 = _global_banded_np(q, t, 64)[0]

        def ceiling(w):
            return (MATCH * (mn - (w + 1)) - 2 * GAP_OPEN
                    - (ad + 2 * (w + 1)) * GAP_EXT)

        ladder_accepts = (sc16 >= ceiling(16) or sc64 >= ceiling(64)
                          or sc16 == sc64)
        if i in got:
            assert ladder_accepts
        else:
            # run overflow (> RUNS_CAP cigar runs) is a legitimate
            # device decline even when the ladder accepts
            from seeksv_tpu.ops.global_device import RUNS_CAP
            n_runs = len(global_align_np(q, t)[1])
            assert not ladder_accepts or n_runs > RUNS_CAP, (
                f"case {i}: ladder accepts at rung<=64 but device "
                f"declined ({n_runs} runs) — decisions desynced")


def test_degenerate_and_boundary_paths():
    """Band-edge walks: leading/trailing indels, j=0 boundary column."""
    rng = np.random.default_rng(3)
    q = rng.integers(0, 4, 300).astype(np.uint8)
    cases = [
        (q, np.concatenate([rng.integers(0, 4, 40).astype(np.uint8), q])),
        (q, np.concatenate([q, rng.integers(0, 4, 40).astype(np.uint8)])),
        (np.concatenate([rng.integers(0, 4, 30).astype(np.uint8), q]), q),
        (np.concatenate([q, rng.integers(0, 4, 30).astype(np.uint8)]), q),
    ]
    qs = [c[0] for c in cases]
    ts = [c[1] for c in cases]
    dev = DeviceGlobalAligner()
    got = dev.align_batch(qs, ts)
    for i, (sc, cig, nm) in got.items():
        ref_sc, ref_cig = global_align_np(qs[i], ts[i])
        assert (sc, cig) == (ref_sc, ref_cig)


def test_engine_device_finalize_bit_parity(tmp_path, monkeypatch):
    """End-to-end engine check: batch_align with the device-finalize
    path enabled (jax on CPU via SEEKSV_TPU_DEVICE_FINALIZE_ON_CPU)
    produces bit-identical alignments to the pure host ladder."""
    from seeksv_tpu.align.engine import BatchAligner
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, 200_000).astype(np.uint8)
    fa = tmp_path / "g.fa"
    code2b = np.frombuffer(b"ACGT", np.uint8)
    with open(fa, "w") as f:
        f.write(">chrX\n")
        f.write(code2b[genome].tobytes().decode() + "\n")
    al = BatchAligner.from_fasta(str(fa))
    reads = []
    for i in range(24):
        p = int(rng.integers(0, 190_000))
        ln = int(rng.integers(600, 1200))
        q = genome[p:p + ln].copy()
        # mutate: substitutions + occasional indels (long regime)
        nmut = int(ln * 0.02)
        pos = rng.integers(0, len(q), nmut)
        q[pos] = (q[pos] + 1 + rng.integers(0, 3, nmut)) % 4
        if i % 3 == 0:
            cut = int(rng.integers(100, ln - 100))
            q = np.concatenate([q[:cut], q[cut + 20:]])  # 20bp deletion
        reads.append(code2b[q].tobytes())
    host = al.batch_align(reads, force_host=True)
    monkeypatch.setenv("SEEKSV_TPU_DEVICE_FINALIZE_ON_CPU", "1")
    monkeypatch.setenv("SEEKSV_TPU_FINALIZE_CROSSOVER_CELLS", "1")
    monkeypatch.setenv("SEEKSV_TPU_FINALIZE_DEVICE_SHARE", "0.55")
    al2 = BatchAligner.from_fasta(str(fa))
    dev = al2.batch_align(reads)
    assert al2.timings["device_finalize_s"] > 0, (
        "device finalize path never ran — test is vacuous")

    def key(a):
        if not a.mapped:
            return ("unmapped",)
        supp = tuple((s.tid, s.pos, s.strand, tuple(s.cigar), s.mapq)
                     for s in (a.supp or []))
        return (a.tid, a.pos, a.strand, tuple(a.cigar), a.score,
                a.mapq, a.nm, a.qb, a.qe, supp)

    for i, (h, d) in enumerate(zip(host, dev)):
        assert key(h) == key(d), f"read {i}: {key(h)} != {key(d)}"


def test_engine_device_finalize_failure_is_loud(tmp_path, monkeypatch):
    """A device finalize that raises must fail the realignment, not turn
    silently into host-only results."""
    from seeksv_tpu.align.engine import BatchAligner
    rng = np.random.default_rng(9)
    genome = rng.integers(0, 4, 50_000).astype(np.uint8)
    fa = tmp_path / "g.fa"
    code2b = np.frombuffer(b"ACGT", np.uint8)
    fa.write_text(">chrX\n" + code2b[genome].tobytes().decode() + "\n")
    reads = []
    for _ in range(6):
        p = int(rng.integers(0, 48_000))
        reads.append(code2b[genome[p:p + 800]].tobytes())

    def boom(self, qs, ts):
        raise RuntimeError("device finalize failed")

    monkeypatch.setattr(DeviceGlobalAligner, "align_batch", boom)
    monkeypatch.setenv("SEEKSV_TPU_DEVICE_FINALIZE_ON_CPU", "1")
    monkeypatch.setenv("SEEKSV_TPU_FINALIZE_CROSSOVER_CELLS", "1")
    monkeypatch.setenv("SEEKSV_TPU_FINALIZE_DEVICE_SHARE", "0.55")
    al = BatchAligner.from_fasta(str(fa))
    with pytest.raises(RuntimeError, match="device finalize failed"):
        al.batch_align(reads)
