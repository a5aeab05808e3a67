"""Device-resident alignment front-end: seed -> candidate windows ->
batched extension, with the windows gathered ON DEVICE.

This closes the loop the roadmap left open after ops/seed_device.py: the
seed kernel's candidate table (diag, q_start, anchor_len per top-8 slot)
stays on device; a second jitted program gathers the left/right query and
target windows straight out of the device-resident read matrix and the
device-resident reference array (the role bwa's FM-index+extension plays
in the reference pipeline, README.md:22-34 / SURVEY.md §7 phase 3); the
batched extension kernel that ops.extend chooses runs on those
device-resident windows, and two tiny elementwise jits apply the bwa-mem
clip/extend decisions between/after the rounds.  The whole chunk costs
ONE host->device upload (the padded read matrix) and ONE device->host
sync (the per-candidate score/coordinate scalars + overflow flag): every
slot (valid or not) is extended rather than syncing a count back for
compaction.

The extension kernels are invoked through their public jitted entry
points, outside any enclosing trace: inlining them into one mega-jit under
a jax.enable_x64 scope corrupts their dispatch cache in jax 0.9
("Execution supplied 5 buffers but compiled program expected 6 buffers" on
the next direct call) — hence the phase structure.

Semantics are identical to the BatchAligner host window path — asserted
by tests/test_align_device.py against the full Alignment outputs.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..align.sw import MATCH, PEN_CLIP
from .seed_device import _seed_core, TOP_CANDIDATES, pad_reads


def device_align_auto_enabled() -> bool:
    """Consult the committed calibration artifact
    (align/device_align_calibration.json, written by
    scripts/calibrate_device_align.py): True only when the measured
    per-chunk comparison found a break-even."""
    import json
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "align",
        "device_align_calibration.json")
    try:
        with open(path) as f:
            be = json.load(f).get("break_even")
        return isinstance(be, dict)
    except (OSError, ValueError):
        return False


@functools.partial(jax.jit,
                   static_argnames=("k", "hit_cap", "n_jobs", "nk", "LT"))
def _seed_and_gather(keys, prefix_tab, shift, positions, ref, chrom_starts,
                     mat, lens, ref_span, k: int, hit_cap: int, n_jobs: int,
                     nk: int, LT: int):
    """Seed all reads and gather the left/right extension windows for
    every (job, slot) candidate pair, entirely on device.

    Returns the four [J, LQ|LT] int32 window matrices (J = n_jobs *
    TOP_CANDIDATES; invalid slots have zero lengths), their int32
    lengths, the int32 h0 vector, the int64 per-candidate coordinate
    scalars the host decision step needs, the per-job candidate counts,
    and the hit_cap overflow flag.
    """
    diag, qs, alen, _votes, n_cand, overflow = _seed_core(
        keys, prefix_tab, shift, positions, mat, lens, ref_span, k,
        hit_cap, n_jobs, nk)
    C = TOP_CANDIDATES
    LP = mat.shape[1]
    N = n_jobs
    J = N * C
    job = jnp.arange(J, dtype=jnp.int64) // C
    slot = jnp.arange(J, dtype=jnp.int64) % C
    valid = slot < n_cand[job]
    d = diag.reshape(-1)
    q0 = jnp.where(valid, qs.reshape(-1), 0)
    al = jnp.where(valid, alen.reshape(-1), 0)
    jlen = jnp.where(valid, lens[job], 0)
    ref_anchor = d + q0
    ra = jnp.clip(ref_anchor, 0, jnp.maximum(ref_span - 1, 0))
    tid = jnp.searchsorted(chrom_starts, ra, side="right") - 1
    tid = jnp.clip(tid, 0, chrom_starts.shape[0] - 2)
    c_lo = chrom_starts[tid]
    c_hi = chrom_starts[tid + 1]
    h0 = (al * MATCH).astype(jnp.int32)
    jr = jnp.arange(LP, dtype=jnp.int64)[None, :]
    tr = jnp.arange(LT, dtype=jnp.int64)[None, :]
    row = job[:, None]

    def gather_q(idx, qlen):
        g = mat[row, jnp.clip(idx, 0, LP - 1)]
        return jnp.where(jr < qlen[:, None], g, 4).astype(jnp.int32)

    def gather_t(idx, tlen):
        g = ref[jnp.clip(idx, 0, jnp.maximum(ref_span - 1, 0))]
        return jnp.where(tr < tlen[:, None], g, 4).astype(jnp.int32)

    # left: reversed read prefix vs reversed upstream reference
    lqlen = q0
    t_lo = jnp.maximum(c_lo, ref_anchor - (q0 + 100))
    ltlen = jnp.where(valid, jnp.maximum(ref_anchor - t_lo, 0), 0)
    lq = gather_q(q0[:, None] - 1 - jr, lqlen)
    lt = gather_t(ref_anchor[:, None] - 1 - tr, ltlen)
    # right: read suffix past the anchor vs downstream reference
    q_end0 = q0 + al
    rqlen = jnp.maximum(jlen - q_end0, 0)
    ref_end0 = ref_anchor + al
    t_hi = jnp.minimum(c_hi, ref_end0 + rqlen + 100)
    rtlen = jnp.where(valid, jnp.maximum(t_hi - ref_end0, 0), 0)
    rq = gather_q(q_end0[:, None] + jr, rqlen)
    rt = gather_t(ref_end0[:, None] + tr, rtlen)
    return (lq, lqlen.astype(jnp.int32), lt, ltlen.astype(jnp.int32),
            rq, rqlen.astype(jnp.int32), rt, rtlen.astype(jnp.int32),
            h0, ref_anchor, q0, q_end0, ref_end0, jlen, tid,
            n_cand, overflow)


@jax.jit
def _left_decision(max_score, gscore, qle, tle, gtle, q0, ref_anchor):
    """Vectorized bwa-mem clip/extend decision after the left round
    (align.engine.Aligner._extend_candidate)."""
    ms = max_score.astype(jnp.int64)
    gs = gscore.astype(jnp.int64)
    use_g = (gs > 0) & (gs > ms - PEN_CLIP)
    qb = jnp.where(use_g, 0, q0 - qle.astype(jnp.int64))
    rb = ref_anchor - jnp.where(use_g, gtle, tle).astype(jnp.int64)
    return qb, rb


@jax.jit
def _right_decision(max_score, gscore, qle, tle, gtle, q_end0, ref_end0,
                    jlen):
    ms = max_score.astype(jnp.int64)
    gs = gscore.astype(jnp.int64)
    use_g = (gs > 0) & (gs > ms - PEN_CLIP)
    qe = jnp.where(use_g, jlen, q_end0 + qle.astype(jnp.int64))
    rend = ref_end0 + jnp.where(use_g, gtle, tle).astype(jnp.int64)
    return ms, qe, rend


class DeviceAligner:
    """Holds the reference + k-mer table as device arrays and runs the
    full seed-and-extend front-end (everything except the final ranking
    and winner-only traceback) on device over strand-expanded read
    batches."""

    def __init__(self, idx, device=None):
        from .extend import extend_kernel, platform
        from .seed_device import DeviceSeeder
        self.idx = idx
        self.seeder = DeviceSeeder(idx, device=device)
        self._extend = extend_kernel(platform())
        with jax.enable_x64(True):
            ref = jnp.asarray(idx.ref)
            starts = jnp.asarray(idx.chrom_starts.astype(np.int64))
            if device is not None:
                ref = jax.device_put(ref, device)
                starts = jax.device_put(starts, device)
            self.ref, self.chrom_starts = ref, starts

    # strand-reads per device batch: keeps the expected hit count within
    # hit_cap (1024 reads x ~230 kmers ~ 2.4e5) and the jit shape set small
    CHUNK = 1024

    def align_jobs(self, reads, hit_cap: int = 1 << 18,
                   max_hit_cap: int = 1 << 22):
        """reads: strand-expanded encoded uint8 code arrays (the same
        contract as DeviceSeeder.seed).  Returns
        {job: [(final, tid, qb, qe, rb, rend), ...]} with candidates in
        the host path's (-votes, diag) order, or None when a chunk's hits
        exceed max_hit_cap even after the retry ladder (caller falls back
        to the host path)."""
        n = len(reads)
        if n > self.CHUNK:
            out = {}
            for c0 in range(0, n, self.CHUNK):
                sub = self.align_jobs(reads[c0:c0 + self.CHUNK],
                                      hit_cap, max_hit_cap)
                if sub is None:
                    return None
                for k2, v in sub.items():
                    out[k2 + c0] = v
            return out
        cap = hit_cap
        while True:
            res = self._align_chunk(reads, cap)
            if res is not None:
                return res
            if cap >= max_hit_cap:
                return None
            cap = min(cap * 4, max_hit_cap)

    def _align_chunk(self, reads, hit_cap: int):
        n = len(reads)
        if n == 0:
            return {}
        padded = pad_reads(reads, self.idx.k)
        if padded is None:
            return {i: [] for i in range(n)}
        mat_np, lens_np, NP, LP = padded
        C = TOP_CANDIDATES
        with jax.enable_x64(True):
            mat = jnp.asarray(mat_np)
            lens = jnp.asarray(lens_np)
            (lq, lql, lt, ltl, rq, rql, rt, rtl, h0, ref_anchor, q0,
             q_end0, ref_end0, jlen, tid, nc, ovf) = _seed_and_gather(
                self.seeder.keys, self.seeder.prefix_tab,
                jnp.int64(self.seeder.shift), self.seeder.positions,
                self.ref, self.chrom_starts, mat, lens,
                jnp.int64(self.seeder.ref_span),
                k=self.idx.k, hit_cap=hit_cap, n_jobs=NP,
                nk=LP - self.idx.k + 1, LT=LP + 128)
        left = self._extend(lq, lql, lt, ltl, h0)
        with jax.enable_x64(True):
            qb, rb = _left_decision(left["max_score"], left["gscore"],
                                    left["qle"], left["tle"], left["gtle"],
                                    q0, ref_anchor)
        right = self._extend(rq, rql, rt, rtl,
                             left["max_score"].astype(jnp.int32))
        with jax.enable_x64(True):
            final, qe, rend = _right_decision(
                right["max_score"], right["gscore"], right["qle"],
                right["tle"], right["gtle"], q_end0, ref_end0, jlen)
            # the single device->host sync of the chunk
            ovf, nc, final, qb, qe, rb, rend, tid = (
                np.asarray(x) for x in
                (ovf, nc, final, qb, qe, rb, rend, tid))
        if bool(ovf):
            return None
        results = {}
        for i in range(n):
            ci = int(nc[i])
            base = i * C
            results[i] = [
                (int(final[base + s]), int(tid[base + s]),
                 int(qb[base + s]), int(qe[base + s]),
                 int(rb[base + s]), int(rend[base + s]))
                for s in range(ci)]
        return results
