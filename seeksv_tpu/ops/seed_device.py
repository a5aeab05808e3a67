"""Device-resident seeding: the batched candidate finder as one jittable
program against the HBM-resident k-mer table.

Same algorithm as align/seed_batch.py:batch_candidates (itself the exact
vectorization of Aligner._candidates, i.e. the seed→chain front-end role of
bwa mem in the reference pipeline — SURVEY.md §2 realignment stage), but
with static shapes so the whole front-end can run on device next to the
extension kernel:

  * rolling 2-bit hashes for all read k-mers (k static → unrolled),
  * one searchsorted pair against the sorted key table,
  * ragged hit expansion replaced by a capped expansion: global cumsum of
    per-kmer hit counts + searchsorted(cumsum, arange(hit_cap)) assigns
    each of `hit_cap` hit slots to its source k-mer,
  * (job, diag, offset) grouping as ONE sort of a packed int64 composite
    key, then runs / votes / longest-anchor as segment reductions,
  * per-job (-votes, diag) ranking as a second sort + rank-within-job
    scatter into fixed [n_jobs, 8] outputs.

k-mer hashes need 2k bits (38 for k=19), so the kernel runs in x64 mode;
the public wrapper enters jax.enable_x64(True) around conversion
and the jitted call.  An `overflow` flag reports when total hits exceeded
hit_cap (caller falls back to the host path; equivalence otherwise is
asserted by tests/test_seed_device.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.ops import segment_max, segment_min, segment_sum

MAX_OCC = 500            # align/seed_batch.py semantics (bwa mem -c 500)
TOP_CANDIDATES = 8
OFF_BITS = 11            # read offsets < 2048


def _bounded_search_jax(keys, q, lo, hi, side: str):
    """Vectorized binary search of q within per-element [lo, hi) bucket
    bounds over the low-bit key array (the device form of
    KmerIndex._bounded_search; iteration count = log2 of the largest
    bucket)."""
    cap = max(keys.shape[0] - 1, 0)

    def cond(c):
        lo, hi = c
        return jnp.any(lo < hi)

    def body(c):
        lo, hi = c
        active = lo < hi
        mid = (lo + hi) >> 1
        kv = keys[jnp.minimum(mid, cap)].astype(q.dtype)
        go = (kv < q) if side == "left" else (kv <= q)
        return (jnp.where(active & go, mid + 1, lo),
                jnp.where(active & ~go, mid, hi))

    lo, _hi = jax.lax.while_loop(cond, body, (lo, hi))
    return lo


def _seed_core(keys, prefix_tab, shift, positions, mat, lens, ref_span,
               k: int, hit_cap: int, n_jobs: int, nk: int):
    """Seeding kernel body: also traced inline by the fused front-end
    (ops.align_device._seed_and_gather).  keys = low-bit residuals of
    the v2 packed index; prefix_tab buckets the top bits."""
    N = n_jobs
    # ---- rolling hashes over all reads ----
    m64 = mat.astype(jnp.int64)
    h = jnp.zeros((N, nk), jnp.int64)
    ok = jnp.ones((N, nk), bool)
    for j in range(k):                     # static k → unrolled
        col = m64[:, j:nk + j]
        h = (h << 2) | col
        ok &= col < 4
    ok &= (jnp.arange(nk)[None, :] + k) <= lens[:, None]
    hflat = h.reshape(-1)
    okflat = ok.reshape(-1)
    # ---- two-level table lookup (prefix bucket + low-bit search) ----
    p = hflat >> shift                     # clamps out-of-range (garbage
    b_lo = prefix_tab[p]                   # hashes are masked by okflat)
    b_hi = prefix_tab[jnp.minimum(p + 1, prefix_tab.shape[0] - 1)]
    q_low = (hflat & ((jnp.int64(1) << shift) - 1)).astype(jnp.int64)
    lo = _bounded_search_jax(keys, q_low, b_lo, b_hi, "left")
    hi = _bounded_search_jax(keys, q_low, lo, b_hi, "right")
    cnt = hi - lo
    cnt = jnp.where(okflat & (cnt > 0) & (cnt <= MAX_OCC), cnt, 0)
    # ---- capped ragged expansion ----
    csum = jnp.cumsum(cnt)
    total = csum[-1]
    overflow = total > hit_cap
    t = jnp.arange(hit_cap, dtype=jnp.int64)
    src = jnp.searchsorted(csum, t, side="right")
    src = jnp.minimum(src, N * nk - 1)
    hit_valid = t < total
    intra = t - (csum[src] - cnt[src])
    pidx = jnp.clip(lo[src] + intra, 0, positions.shape[0] - 1)
    pos = positions[pidx]
    job = src // nk
    off = src % nk
    diag = pos - off
    # ---- group by (job, diag), runs of consecutive offsets: one sort ----
    dshift = diag + (1 << OFF_BITS)            # >= 0 (diag >= -nk)
    dspan = ref_span + (2 << OFF_BITS)
    job_k = jnp.where(hit_valid, job, N)       # padding sorts last
    ckey = (job_k * dspan + jnp.where(hit_valid, dshift, 0)) << OFF_BITS
    ckey = ckey | jnp.where(hit_valid, off, 0)
    order = jnp.argsort(ckey)
    jS = job_k[order]
    dS = jnp.where(hit_valid[order], diag[order], jnp.int64(1) << 50)
    oS = off[order]
    vS = hit_valid[order]
    prev_same_key = jnp.concatenate(
        [jnp.zeros(1, bool), (jS[1:] == jS[:-1]) & (dS[1:] == dS[:-1])])
    new_key = ~prev_same_key
    jump = jnp.concatenate([jnp.ones(1, bool), oS[1:] != oS[:-1] + 1])
    new_run = new_key | jump
    run_id = jnp.cumsum(new_run) - 1
    key_id = jnp.cumsum(new_key) - 1
    H = hit_cap
    one = jnp.ones(H, jnp.int64)
    run_len = segment_sum(one, run_id, num_segments=H)
    run_first = segment_min(jnp.arange(H, dtype=jnp.int64), run_id,
                            num_segments=H)
    run_key = segment_min(key_id, run_id, num_segments=H)
    # longest run per key, earliest start on ties (host uses strict >)
    score = run_len * H + (H - 1 - run_first)
    best = segment_max(jnp.where(run_len > 0, score, 0), run_key,
                       num_segments=H)
    best_len = best // H
    best_first = H - 1 - (best % H)
    anchor_start = oS[jnp.clip(best_first, 0, H - 1)]
    anchor_len = best_len + k - 1
    key_votes = segment_sum(jnp.where(vS, 1, 0).astype(jnp.int64), key_id,
                            num_segments=H)
    key_job = segment_min(jnp.where(vS, jS, N), key_id, num_segments=H)
    key_diag = segment_min(dS, key_id, num_segments=H)
    # ---- rank per job: (-votes, diag), top 8 ----
    live = key_votes > 0
    key_job = jnp.where(live, key_job, N)
    rank = jnp.lexsort((key_diag, -key_votes, key_job))
    jR = key_job[rank]
    new_job = jnp.concatenate([jnp.ones(1, bool), jR[1:] != jR[:-1]])
    idxs = jnp.arange(H, dtype=jnp.int64)
    job_start = jax.lax.cummax(jnp.where(new_job, idxs, 0))
    in_job = idxs - job_start
    keep = (jR < N) & (in_job < TOP_CANDIDATES) & (key_votes[rank] > 0)
    row = jnp.where(keep, jR, N)
    col = jnp.where(keep, in_job, 0)
    def scat(vals, fill):
        out = jnp.full((N + 1, TOP_CANDIDATES), fill, jnp.int64)
        return out.at[row, col].set(jnp.where(keep, vals, fill))[:N]
    out_diag = scat(key_diag[rank], 0)
    out_qs = scat(anchor_start[rank], 0)
    out_alen = scat(anchor_len[rank], 0)
    out_votes = scat(key_votes[rank], 0)
    n_cand = segment_sum(jnp.where(keep, 1, 0).astype(jnp.int32),
                         row.astype(jnp.int32), num_segments=N + 1)[:N]
    return out_diag, out_qs, out_alen, out_votes, n_cand, overflow


_seed_kernel = functools.partial(
    jax.jit, static_argnames=("k", "hit_cap", "n_jobs", "nk"))(_seed_core)


def pad_reads(reads, k: int):
    """Pad a list of encoded uint8 code arrays into a [NP, LP] matrix of
    codes (fill 4 = ambiguous) plus int64 lengths; both batch dims padded
    to 64-multiples to bound the jit cache.  Returns (mat, lens, NP, LP)
    or None when the batch has no read of at least k bases (no kmers)."""
    n = len(reads)
    lens = np.asarray([len(r) for r in reads], np.int64)
    L = int(lens.max(initial=0))
    if n == 0 or L < k:
        return None
    NP = -(-n // 64) * 64
    LP = min(-(-L // 64) * 64, 1 << OFF_BITS)
    if L > LP:
        raise ValueError(f"read length {L} exceeds device seeder cap {LP}")
    mat = np.full((NP, LP), 4, np.uint8)
    for i, r in enumerate(reads):
        mat[i, :len(r)] = r
    lens = np.concatenate([lens, np.zeros(NP - n, np.int64)])
    return mat, lens, NP, LP


class DeviceSeeder:
    """Holds the k-mer table as device arrays (resident in device memory) and
    runs the seeding kernel over padded read batches."""

    def __init__(self, idx, device=None):
        self.k = idx.k
        self.ref_span = int(idx.chrom_starts[-1])
        self.shift = idx._prefix_shift(idx.k)
        with jax.enable_x64(True):
            # v2 packed table: low-bit residuals (uint16 -> int64 widen
            # happens per-gather, not in HBM) + int64 bucket table
            keys = jnp.asarray(idx.keys)
            ptab = jnp.asarray(np.asarray(idx.prefix_tab, np.int64))
            pos = jnp.asarray(idx.positions.astype(np.int64))
            if device is not None:
                keys = jax.device_put(keys, device)
                ptab = jax.device_put(ptab, device)
                pos = jax.device_put(pos, device)
            self.keys, self.prefix_tab, self.positions = keys, ptab, pos

    def seed(self, reads, hit_cap: int = 1 << 18):
        """reads: list of encoded uint8 code arrays.  Returns the same
        {job: [(diag, q_start, anchor_len, votes), ...]} mapping as
        align.seed_batch.batch_candidates, or None on hit_cap overflow
        (caller falls back to the host path)."""
        n = len(reads)
        padded = pad_reads(reads, self.k)
        if padded is None:
            return {i: [] for i in range(n)}
        mat, lens, NP, LP = padded
        with jax.enable_x64(True):
            d, qs, al, vo, nc, ovf = _seed_kernel(
                self.keys, self.prefix_tab, jnp.int64(self.shift),
                self.positions, jnp.asarray(mat),
                jnp.asarray(lens), jnp.int64(self.ref_span),
                k=self.k, hit_cap=hit_cap, n_jobs=NP, nk=LP - self.k + 1)
            if bool(ovf):
                return None
            d, qs, al, vo, nc = (np.asarray(x) for x in (d, qs, al, vo, nc))
        return {i: [(int(d[i, j]), int(qs[i, j]), int(al[i, j]),
                     int(vo[i, j])) for j in range(int(nc[i]))]
                for i in range(n)}
