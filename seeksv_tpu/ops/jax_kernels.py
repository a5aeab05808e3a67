"""Jittable JAX kernels for the hot compute paths.

These are the device equivalents of the host/numpy reference
implementations (ops.matchrate, align.sw, pipeline.getsv coverage):

- sw_extend_batch:  batched anchored affine-gap extension (the aligner's
  inner loop).  The row-wise gap recurrence (lazy-F) is replaced by an
  exact prefix-max formulation: because gap-reopening from a gap cell is
  never optimal (open penalty > 0), F[j] = max_k<j (G[k] - open - (j-k)e)
  with G = max(diag, E) — a cummax over the query axis, fully vectorized
  across [batch, query] with a lax.scan over target rows.
- match_rate_pairs_*: batched positional match-rate comparators.
- coverage_from_segments: depth arrays via scatter-add.

All kernels take padded fixed-shape arrays (static shapes for XLA) with
explicit length vectors and are safe under jit/vmap/shard_map.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

MATCH = 1
MISMATCH = 4
GAP_OPEN = 6
GAP_EXT = 1
AMBIG = -1
NEG_INF = jnp.int32(-0x40000000 // 2)


def _sub_scores(q_codes, t_code):
    """Score of each query code against one target code column.
    q_codes: [B, LQ] int32 in 0..4 (4 = ambiguous/padding)."""
    ambig = (q_codes > 3) | (t_code > 3)
    eq = q_codes == t_code
    return jnp.where(ambig, AMBIG, jnp.where(eq, MATCH, -MISMATCH))


@functools.partial(jax.jit, static_argnames=())
def sw_extend_batch(q: jnp.ndarray, qlen: jnp.ndarray, t: jnp.ndarray,
                    tlen: jnp.ndarray, h0: jnp.ndarray):
    """Batched ksw-extend scoring.

    Args:
      q:  [B, LQ] int32 query codes (pad with 4)
      qlen: [B] int32 query lengths
      t:  [B, LT] int32 target codes (pad with 4)
      tlen: [B] int32 target lengths
      h0: [B] int32 anchor scores
    Returns dict of [B] arrays: max_score, qle, tle, gscore, gtle —
    identical to align.sw.extend_score per element.
    """
    B, LQ = q.shape
    LT = t.shape[1]
    # codes may arrive as int8 (4x cheaper host->device upload); widen
    # on device
    q = q.astype(jnp.int32)
    t = t.astype(jnp.int32)
    jidx = jnp.arange(1, LQ + 1, dtype=jnp.int32)  # [LQ]
    # initial row: h[0]=h0; h[j] = h0 - open - j*ext while >= 0
    row0 = h0[:, None] - GAP_OPEN - jidx[None, :] * GAP_EXT
    # emulate the "break on first negative" (monotone decreasing => same)
    row0 = jnp.where(row0 >= 0, row0, NEG_INF)
    h_init = jnp.concatenate([h0[:, None], row0], axis=1)  # [B, LQ+1]
    e_init = jnp.full((B, LQ + 1), NEG_INF, jnp.int32)

    valid_q = jidx[None, :] <= qlen[:, None]  # [B, LQ]
    h_init = jnp.where(jnp.concatenate(
        [jnp.ones((B, 1), bool), valid_q], axis=1), h_init, NEG_INF)

    ZDROP = 100

    def body(carry, i):
        h, e, best, qle, tle, gscore, gtle, dead = carry
        active = (i < tlen) & ~dead  # [B]
        t_code = t[jnp.arange(B), jnp.minimum(i, LT - 1)]
        sub = _sub_scores(q, t_code[:, None])  # [B, LQ]
        diag = h[:, :-1] + sub
        ecand = jnp.maximum(h - GAP_OPEN, e) - GAP_EXT  # [B, LQ+1]
        g = jnp.maximum(diag, ecand[:, 1:])             # [B, LQ]
        # exact F via prefix max: f_j = max_{1<=k<j}(g_k + k*ext) - open - j*ext
        # (gap-reopening from an F-sourced cell is never optimal, and the
        # first-column cell does not feed F — matches align.sw.extend_score)
        h0_col = h0 - GAP_OPEN - (i + 1) * GAP_EXT
        u = g + jidx[None, :] * GAP_EXT                 # [B, LQ]
        pref = jnp.concatenate(
            [jnp.full((B, 1), NEG_INF, jnp.int32),
             jax.lax.cummax(u, axis=1)[:, :-1]], axis=1)
        f = pref - GAP_OPEN - jidx[None, :] * GAP_EXT
        h_row = jnp.maximum(g, f)                       # [B, LQ]
        h_row = jnp.where(valid_q, h_row, NEG_INF)
        new_h = jnp.concatenate([h0_col[:, None], h_row], axis=1)
        new_e = jnp.concatenate([jnp.full((B, 1), NEG_INF, jnp.int32),
                                 jnp.where(valid_q, ecand[:, 1:], NEG_INF)],
                                axis=1)
        row_best = jnp.max(h_row, axis=1)
        row_arg = jnp.argmax(h_row, axis=1).astype(jnp.int32) + 1
        improved = active & (row_best > best)
        best2 = jnp.where(improved, row_best, best)
        qle2 = jnp.where(improved, row_arg, qle)
        tle2 = jnp.where(improved, i + 1, tle)
        h_at_qlen = new_h[jnp.arange(B), qlen]
        gimp = active & (h_at_qlen > gscore)
        gscore2 = jnp.where(gimp, h_at_qlen, gscore)
        gtle2 = jnp.where(gimp, i + 1, gtle)
        dead2 = dead | (active & (row_best < best2 - ZDROP))
        h_keep = jnp.where(active[:, None], new_h, h)
        e_keep = jnp.where(active[:, None], new_e, e)
        return (h_keep, e_keep, best2, qle2, tle2, gscore2, gtle2, dead2), None

    zeros = jnp.zeros(B, jnp.int32)
    init = (h_init, e_init, h0.astype(jnp.int32), zeros, zeros,
            jnp.full(B, NEG_INF, jnp.int32), zeros, jnp.zeros(B, bool))
    (h, e, best, qle, tle, gscore, gtle, _), _ = jax.lax.scan(
        body, init, jnp.arange(LT, dtype=jnp.int32))
    return {"max_score": best, "qle": qle, "tle": tle,
            "gscore": gscore, "gtle": gtle}


@jax.jit
def match_rate_pairs_begin(a: jnp.ndarray, alen: jnp.ndarray,
                           b: jnp.ndarray, blen: jnp.ndarray):
    """Batched CompareStringBeginFirst: [N, L] uint8 pairs -> [N] float64-ish
    rates (returns matches and minlen; divide host-side to keep C++ NaN
    semantics for empty inputs)."""
    L = a.shape[1]
    idx = jnp.arange(L)[None, :]
    n = jnp.minimum(alen, blen)[:, None]
    m = (a == b) & (idx < n)
    return jnp.sum(m, axis=1), n[:, 0]


@jax.jit
def match_rate_pairs_end(a: jnp.ndarray, alen: jnp.ndarray,
                         b: jnp.ndarray, blen: jnp.ndarray):
    """Batched CompareStringEndFirst: compares right-anchored by shifting
    each row so its end aligns with the buffer end is the caller's job;
    here we compare a[alen-1-i] vs b[blen-1-i] via gathers."""
    L = a.shape[1]
    idx = jnp.arange(L)[None, :]
    n = jnp.minimum(alen, blen)
    ia = jnp.clip(alen[:, None] - 1 - idx, 0, L - 1)
    ib = jnp.clip(blen[:, None] - 1 - idx, 0, L - 1)
    av = jnp.take_along_axis(a, ia, axis=1)
    bv = jnp.take_along_axis(b, ib, axis=1)
    m = (av == bv) & (idx < n[:, None])
    return jnp.sum(m, axis=1), n


@functools.partial(jax.jit, static_argnames=("length",))
def coverage_from_segments(starts: jnp.ndarray, ends: jnp.ndarray,
                           weights: jnp.ndarray, length: int):
    """Depth array from [S] segment (start, end) pairs via scatter-add on a
    difference array (the device replacement for the mplp pileup)."""
    diff = jnp.zeros(length + 1, jnp.int32)
    diff = diff.at[jnp.clip(starts, 0, length)].add(weights)
    diff = diff.at[jnp.clip(ends, 0, length)].add(-weights)
    return jnp.cumsum(diff)[:length]


@functools.partial(jax.jit, static_argnames=("window_cap",))
def discordant_count_batch(
    # per-read arrays (one chromosome, coordinate-sorted)
    pos, end, lq, mpos, mtid, fwd, mfwd, base_ok,
    # per-junction arrays
    lo, hi, beg, up_pos, down_pos, down_tid, same_tid, case_code,
    min_ins, max_ins,
    window_cap: int = 2048,
):
    """Batched discordant-read-pair counting: the device formulation of
    FindDiscordantReadPairs (ref: getsv.cpp:990-1120) — each junction's
    window [lo, hi) over the sorted read arrays becomes a fixed-cap gather
    + boolean reductions, replacing per-junction BAM index seeks.

    case_code: 0 = +/+, 1 = -/+, 2 = +/-.
    min_ins/max_ins are scalars broadcast per junction; the +/+ tandem-dup
    modular insert-size loop (ref :1081-1091) is closed-form.
    Returns [J] counts, exactly matching DiscordantCounter.count.
    """
    K = 5  # kCrossLength (ref: getsv.cpp:15)
    J = lo.shape[0]
    widx = jnp.arange(window_cap)[None, :]                # [1, W]
    gidx = jnp.clip(lo[:, None] + widx, 0, pos.shape[0] - 1)
    valid = lo[:, None] + widx < hi[:, None]              # [J, W]

    def g(a):
        return a[gidx]

    p, e, l, mp = g(pos), g(end), g(lq), g(mpos)
    up = up_pos[:, None]
    dn = down_pos[:, None]
    m = (valid & g(base_ok) & (e > beg[:, None])
         & (g(mtid) == down_tid[:, None]))
    fw, mf = g(fwd), g(mfwd)
    mini = min_ins[:, None]
    maxi = max_ins[:, None]

    # case 0: +/+ (fwd read, rev mate) incl. tandem-dup modular loop
    c0 = (m & (p + l <= up + K) & (mp + 1 >= dn - K) & fw & ~mf)
    ins0 = up - p + mp + l - dn + 1
    period = up - dn + 1
    tandem_ok = same_tid[:, None] & (up > dn) & (period + 2 * l <= maxi)
    k0 = jnp.maximum(0, -(-(mini - ins0) // jnp.maximum(period, 1)))
    hit_tandem = tandem_ok & (ins0 + k0 * period <= maxi)
    hit_plain = (mini <= ins0) & (ins0 <= maxi)
    hit0 = c0 & jnp.where(tandem_ok, hit_tandem, hit_plain)
    # case 1: -/+ (both reverse)
    c1 = m & ~fw & ~mf & (mp + 1 >= dn - K)
    ins1 = p + 1 - up + 1 + mp + l - dn + 1
    hit1 = c1 & (mini <= ins1) & (ins1 <= maxi)
    # case 2: +/- (both forward)
    c2 = m & fw & mf & (p + l <= up + K) & (mp + l <= dn + K)
    ins2 = up - p + dn - (mp + l) + 1
    hit2 = c2 & (mini <= ins2) & (ins2 <= maxi)

    sel = jnp.stack([hit0, hit1, hit2], axis=0)           # [3, J, W]
    hits = jnp.take_along_axis(
        sel, case_code[None, :, None].astype(jnp.int32), axis=0)[0]
    return jnp.sum(hits, axis=1).astype(jnp.int32)


@jax.jit
def revcomp_batch(seq: jnp.ndarray, lens: jnp.ndarray):
    """Batched reverse complement of code arrays (0-3 bases, 4 = N),
    right-padded; output stays right-padded."""
    L = seq.shape[1]
    idx = jnp.arange(L)[None, :]
    src = jnp.clip(lens[:, None] - 1 - idx, 0, L - 1)
    rev = jnp.take_along_axis(seq, src, axis=1)
    comp = jnp.where(rev < 4, 3 - rev, rev)
    return jnp.where(idx < lens[:, None], comp, seq)
