"""The REAL pipeline on the device mesh.

This module is the SPMD formulation of the full evidence → junction →
support → filter pipeline, consuming actual BAM arrays (not synthetic
batches) and producing sv rows value-identical to the sequential host
pass (pipeline/getclip.py + pipeline/getsv.py), which is itself
byte-identical to the reference binary.  Decomposition (SURVEY.md §2
parallelism call-out):

  * getclip consensus — reads grouped by breakpoint key (tid, side, pos);
    groups are data-parallel across the mesh, the greedy first-match merge
    runs on-device (ops/consensus_scan.py); keys partition exactly, so no
    halos are needed (ref per-chromosome flush proves the independence,
    clip_reads.h:423-446).
  * realignment — extension jobs batch-sharded across the mesh (the
    FLOP-dominant stage; the kernel ops.extend chooses, under shard_map).
  * junction tables — per-shard event generation (getsv.junction_event is
    pure and order-preserving per clip group), encoded as fixed-shape
    6-tuple key + SeqInfo payload arrays, all-gathered across the mesh
    (jax.lax.all_gather), then replayed in original order into the
    ordered multimap (the keyed global reduction that replaces the
    reference's multimap accumulation, getsv.cpp:1805-1835).
  * MergeJunction — partitioned at safe cut points: the merge scan only
    interacts within `search_length` (±50bp, ref getsv.cpp:1355) of
    up_pos among equal (up_chr, down_chr, up_strand, down_strand)
    prefixes, so cutting the sorted table at prefix changes or up_pos
    gaps > search_length yields independent partitions — exact, no
    reconciliation (merge_junction_sharded).
  * insert-size model — first-N masking via a cross-shard prefix count
    (all_gather of shard totals) + histogram psum; the host finishes the
    exact integer mean / truncated deviation (cluster.cpp:15-83).
  * coverage/depth — per-op M/=/X segments (getsv.depth_segments)
    scatter-added per shard, psum over dp, genome axis sharded over gp
    (sequence parallelism over coordinates; bam2depth.cpp:75-129).
  * discordant pairs — junction windows sharded across the mesh, counted
    with the fixed-cap gather kernel (ops/jax_kernels.discordant_count_batch,
    = FindDiscordantReadPairs getsv.cpp:990-1120).

Value parity with the host pass is asserted by
tests/test_spmd_pipeline.py (1/2/8-device sweeps) and by
__graft_entry__.dryrun_multichip, which runs this on the example BAM and
compares the final sv rows.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io.bam import (BamRecords, FDUP, FMREVERSE, FMUNMAP, FREVERSE,
                      FUNMAP, OP_H, OP_S, read_bam)
from ..ops import cigar as cg
from ..pipeline.getclip import (_get_sclip_read, _map_len_no_x,
                                _store_unmapped)
from ..pipeline.getsv import (AlignReadsInfo, DepthQuery, DiscordantCounter,
                              JunctionMap, SV_HEADER, depth_segments,
                              insert_junction_event, iter_soft_groups,
                              junction_event, merge_junction,
                              output_breakpoints)
from ..pipeline.junctions import OtherInfo, SeqInfo

_OPS = "MIDNSHP=X"
_OP_IDX = {c: i for i, c in enumerate(_OPS)}


# --------------------------------------------------------------------------
# getclip on the mesh
# --------------------------------------------------------------------------

class _EventSink:
    """Stands in for BreakpointMap during stream extraction: records the
    ordered insert events instead of merging them."""

    def __init__(self):
        self.events: List[tuple] = []

    def insert(self, pos, s_l, q_l, s_r, q_r, cigar, limit, left_clipped):
        self.events.append((int(pos), s_l, q_l, s_r, q_r, list(cigar)))


def clip_insert_streams(recs: BamRecords, threshold: float, min_mapq: int,
                        save_low_quality: bool):
    """Replays getclip's streaming loop (incl. the flush/drop quirks,
    clip_reads.h:423-438) but captures the per-flush-segment ordered
    insert-event streams instead of merging.  Returns
    [(tid, left_events, right_events)] in flush order."""
    flag = recs.flag
    unmapped_any = (flag & (FUNMAP | FMUNMAP)) != 0
    mapped = ~unmapped_any
    first_op = recs.first_op()
    last_op = recs.last_op()
    has_hard = (first_op == OP_H) | (last_op == OP_H)
    clip_candidate = (mapped & ~has_hard
                      & ((first_op == OP_S) | (last_op == OP_S))
                      & (recs.mapq >= min_mapq) & ((flag & FDUP) == 0))
    first_len = recs.first_len()
    last_len = recs.last_len()
    map_len = _map_len_no_x(recs)

    segments: List[Tuple[int, list, list]] = []
    left_sink, right_sink = _EventSink(), _EventSink()

    def flush(tid):
        segments.append((tid, left_sink.events, right_sink.events))
        left_sink.events = []
        right_sink.events = []

    mapped_idx = np.nonzero(mapped)[0]
    last_tid = 0
    if len(mapped_idx):
        mtids = recs.tid[mapped_idx]
        run_starts = np.concatenate(
            [[0], np.nonzero(mtids[1:] != mtids[:-1])[0] + 1, [len(mtids)]])
        for r in range(len(run_starts) - 1):
            s, e = int(run_starts[r]), int(run_starts[r + 1])
            tid = int(mtids[s])
            if tid != last_tid:
                flush(last_tid)
                last_tid = tid
                s += 1  # quirk: flush-triggering record is dropped
            run = mapped_idx[s:e]
            for i in run[clip_candidate[run]]:
                _get_sclip_read(recs, int(i), left_sink, right_sink,
                                threshold, save_low_quality, first_op,
                                last_op, first_len, last_len, map_len)
    flush(last_tid)
    return segments


def _mesh_spec(mesh, extra_dims=0):
    from jax.sharding import PartitionSpec as P
    return P(tuple(mesh.axis_names), *([None] * extra_dims))


def mesh_consensus(mesh, group_keys: List[tuple], group_events: List[list],
                   threshold: float) -> Dict[tuple, list]:
    """Consensus merge of breakpoint-key groups on the device mesh
    (ops/consensus_scan.py): groups padded to fixed shapes, sharded over
    all mesh devices; the host reconstructs sequences/qualities/CIGARs
    from the returned src indices (side replacement is wholesale).
    Shared by the whole-file spmd_getclip and the slab-streaming
    SpmdGetclipStream (parallel/stream_spmd.py)."""
    import jax
    from jax.sharding import NamedSharding

    from ..ops.consensus_scan import consensus_scan_groups

    consensus: Dict[tuple, list] = {}
    if not group_events:
        return consensus
    frac = Fraction(threshold).limit_denominator(100000)
    NG = len(group_events)
    G = max(len(v) for v in group_events)
    LL = max((len(ev[1]) for v in group_events for ev in v), default=1)
    LR = max((len(ev[3]) for v in group_events for ev in v), default=1)
    LL, LR = max(LL, 1), max(LR, 1)
    ndev = mesh.size
    NGp = -(-NG // ndev) * ndev
    seq_l = np.zeros((NGp, G, LL), np.uint8)
    seq_r = np.zeros((NGp, G, LR), np.uint8)
    len_l = np.zeros((NGp, G), np.int32)
    len_r = np.zeros((NGp, G), np.int32)
    n_reads = np.zeros(NGp, np.int32)
    for k, evs in enumerate(group_events):
        n_reads[k] = len(evs)
        for ri, (_pos, s_l, _q_l, s_r, _q_r, _cig) in enumerate(evs):
            seq_l[k, ri, LL - len(s_l):] = s_l   # right-aligned
            len_l[k, ri] = len(s_l)
            seq_r[k, ri, :len(s_r)] = s_r
            len_r[k, ri] = len(s_r)
    spec3 = NamedSharding(mesh, _mesh_spec(mesh, 2))
    spec2 = NamedSharding(mesh, _mesh_spec(mesh, 1))
    spec1 = NamedSharding(mesh, _mesh_spec(mesh, 0))
    max_slots = 8
    while True:
        out = consensus_scan_groups(
            jax.device_put(seq_l, spec3), jax.device_put(len_l, spec2),
            jax.device_put(seq_l, spec3),
            jax.device_put(seq_r, spec3), jax.device_put(len_r, spec2),
            jax.device_put(seq_r, spec3),
            jax.device_put(n_reads, spec1),
            frac.numerator, frac.denominator, max_slots=max_slots)
        if not bool(np.asarray(out["overflow"]).any()) or max_slots >= G:
            break
        max_slots = G  # every read could be its own slot: cannot overflow
    n_slots = np.asarray(out["n_slots"])
    support = np.asarray(out["support"])
    src_l = np.asarray(out["src_l"])
    src_r = np.asarray(out["src_r"])
    for k, key in enumerate(group_keys):
        evs = group_events[k]
        entries = []
        for s in range(int(n_slots[k])):
            el = evs[int(src_l[k, s])]
            er = evs[int(src_r[k, s])]
            # CIGAR follows the aligned side (ref clip_reads.cpp:69-75):
            # side 5 (left-clipped) -> right part; side 3 -> left part
            cig = er[5] if key[1] == 0 else el[5]
            entries.append((el[1], el[2], er[3], er[4], cig,
                            int(support[k, s])))
        consensus[key] = entries
    return consensus


def spmd_getclip(mesh, bam_path: str, prefix: str, threshold: float = 0.85,
                 min_mapq: int = 20, save_low_quality: bool = False,
                 recs: Optional[BamRecords] = None) -> None:
    """getclip with the consensus merge executed on the device mesh (see
    mesh_consensus); outputs byte-identical to the host pass."""
    import gzip

    if recs is None:
        recs = read_bam(bam_path)

    soft_out = gzip.open(f"{prefix}.clip.gz", "wt", compresslevel=1)
    fq_out = gzip.open(f"{prefix}.clip.fq.gz", "wt", compresslevel=1)
    # binary: _store_unmapped writes bytes
    un1 = gzip.open(f"{prefix}.unmapped_1.fq.gz", "wb", compresslevel=1)
    un2 = gzip.open(f"{prefix}.unmapped_2.fq.gz", "wb", compresslevel=1)
    id2seq_qual: Dict[bytes, tuple] = {}
    for i in np.nonzero((recs.flag & (FUNMAP | FMUNMAP)) != 0)[0]:
        _store_unmapped(recs, int(i), id2seq_qual, un1, un2)

    segments = clip_insert_streams(recs, threshold, min_mapq,
                                   save_low_quality)
    # group events by (segment, side, pos), preserving stream order
    group_keys: List[tuple] = []
    group_events: List[list] = []
    gidx: Dict[tuple, int] = {}
    for si, (tid, lev, rev) in enumerate(segments):
        for side, events in ((0, lev), (1, rev)):
            for ev in events:
                key = (si, side, ev[0])
                k = gidx.get(key)
                if k is None:
                    k = gidx[key] = len(group_keys)
                    group_keys.append(key)
                    group_events.append([])
                group_events[k].append(ev)

    consensus = mesh_consensus(mesh, group_keys, group_events, threshold)

    # emit in flush order, sides 5 then 3, positions ascending
    for si, (tid, _lev, _rev) in enumerate(segments):
        chrom = recs.ref_names[tid] if 0 <= tid < len(recs.ref_names) \
            else str(tid)
        for side, orient in ((0, "5"), (1, "3")):
            keys = sorted(k for k in consensus if k[0] == si and k[1] == side)
            for key in keys:
                for (s_l, q_l, s_r, q_r, cig, sup) in consensus[key]:
                    if orient == "5":
                        aligned, aligned_q = s_r, q_r
                        clipped, clipped_q = s_l, q_l
                    else:
                        aligned, aligned_q = s_l, q_l
                        clipped, clipped_q = s_r, q_r
                    soft_out.write(
                        f"{chrom}\t{key[2]}\t{orient}\t{cg.to_str(cig)}\t"
                        f"{aligned.tobytes().decode()}\t"
                        f"{aligned_q.tobytes().decode()}\t"
                        f"{clipped.tobytes().decode()}\t"
                        f"{clipped_q.tobytes().decode()}\t{sup}\n")
                    cs = clipped.tobytes().decode()
                    fq_out.write(f"@{cs}\n{cs}\n+\n"
                                 f"{clipped_q.tobytes().decode()}\n")
    soft_out.close()
    fq_out.close()
    un1.close()
    un2.close()


# --------------------------------------------------------------------------
# junction table all-gather
# --------------------------------------------------------------------------

@dataclass
class _EncodedEvents:
    """Fixed-shape encoding of junction events (key 6-tuple + SeqInfo
    payloads) for the mesh all-gather."""
    key: np.ndarray        # [E, 6] int32
    useq: np.ndarray       # [E, LS] uint8
    dseq: np.ndarray       # [E, LS] uint8
    ulen: np.ndarray       # [E] int32
    dlen: np.ndarray       # [E] int32
    ucig: np.ndarray       # [E, C] uint32 (len<<4 | op)
    dcig: np.ndarray       # [E, C] uint32
    meta: np.ndarray       # [E, 10] int32: n_ucig, n_dcig, up(lcl,rcl,support,uniq), down(lcl,rcl,support,uniq)
    valid: np.ndarray      # [E] bool


def _encode_events(events, name2id, E, LS, C):
    key = np.zeros((E, 6), np.int32)
    useq = np.zeros((E, LS), np.uint8)
    dseq = np.zeros((E, LS), np.uint8)
    ulen = np.zeros(E, np.int32)
    dlen = np.zeros(E, np.int32)
    ucig = np.zeros((E, C), np.uint32)
    dcig = np.zeros((E, C), np.uint32)
    meta = np.zeros((E, 10), np.int32)
    valid = np.zeros(E, bool)
    for i, (j, up, down) in enumerate(events):
        key[i] = (name2id[j[0]], j[1], 0 if j[2] == "+" else 1,
                  name2id[j[3]], j[4], 0 if j[5] == "+" else 1)
        ub = np.frombuffer(up.seq, np.uint8)
        db = np.frombuffer(down.seq, np.uint8)
        useq[i, :len(ub)] = ub
        dseq[i, :len(db)] = db
        ulen[i], dlen[i] = len(ub), len(db)
        for c, (ln, op) in enumerate(up.cigar):
            ucig[i, c] = (ln << 4) | _OP_IDX[op]
        for c, (ln, op) in enumerate(down.cigar):
            dcig[i, c] = (ln << 4) | _OP_IDX[op]
        meta[i, 0] = len(up.cigar)
        meta[i, 1] = len(down.cigar)
        meta[i, 2:6] = (up.lcl, up.rcl, up.support, up.uniq)
        meta[i, 6:10] = (down.lcl, down.rcl, down.support, down.uniq)
        valid[i] = True
    return _EncodedEvents(key, useq, dseq, ulen, dlen, ucig, dcig, meta,
                          valid)


def _decode_event(enc: _EncodedEvents, i: int, id2name):
    k = enc.key[i]
    j = (id2name[k[0]], int(k[1]), "+" if k[2] == 0 else "-",
         id2name[k[3]], int(k[4]), "+" if k[5] == 0 else "-")
    m = enc.meta[i]
    ucig = [((int(v) >> 4), _OPS[int(v) & 0xF])
            for v in enc.ucig[i, :m[0]]]
    dcig = [((int(v) >> 4), _OPS[int(v) & 0xF])
            for v in enc.dcig[i, :m[1]]]
    up = SeqInfo(enc.useq[i, :enc.ulen[i]].tobytes(), ucig,
                 int(m[2]), int(m[3]), int(m[4]), int(m[5]))
    down = SeqInfo(enc.dseq[i, :enc.dlen[i]].tobytes(), dcig,
                   int(m[6]), int(m[7]), int(m[8]), int(m[9]))
    return j, up, down


def _gather_window(mesh, jmap, groups, rescue, rescue_events):
    """One window of clip groups through the mesh: shard contiguously,
    generate events, encode, all-gather, replay in original order."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    ndev = mesh.size
    per_shard_events: List[list] = [[] for _ in range(ndev)]
    bounds = np.linspace(0, len(groups), ndev + 1).astype(int)
    for s in range(ndev):
        for ari, orient, cais in groups[bounds[s]:bounds[s + 1]]:
            for cai in cais:
                ev = junction_event(ari, orient, cai, rescue)
                if ev is None:
                    continue
                if ev[0] == "rescue":
                    rescue_events.append((ev[1], ev[2]))
                else:
                    per_shard_events[s].append(ev[1:])

    n_events = sum(len(e) for e in per_shard_events)
    if n_events == 0:
        return

    all_ev = [e for s in per_shard_events for e in s]
    names = []
    seen = set()
    for (j, _u, _d) in all_ev:
        for nm in (j[0], j[3]):
            if nm not in seen:
                seen.add(nm)
                names.append(nm)
    name2id = {n: i for i, n in enumerate(names)}

    def _pow2(n):
        b = 8
        while b < n:
            b <<= 1
        return b

    # pow2 pads bound the jit cache across windows (windowed ingestion
    # would otherwise recompile the gather per window shape)
    E = _pow2(max(len(e) for e in per_shard_events))
    LS = _pow2(max(max(len(u.seq), len(d.seq)) for (_j, u, d) in all_ev))
    C = _pow2(max(max(len(u.cigar), len(d.cigar), 1)
                  for (_j, u, d) in all_ev))
    encs = [_encode_events(ev, name2id, E, LS, C)
            for ev in per_shard_events]

    def stack(attr):
        return np.concatenate([getattr(e, attr) for e in encs], axis=0)

    arrays = {a: stack(a) for a in ("key", "useq", "dseq", "ulen", "dlen",
                                    "ucig", "dcig", "meta", "valid")}

    axes = tuple(mesh.axis_names)

    def gather_body(*xs):
        return tuple(
            jax.lax.all_gather(
                jax.lax.all_gather(x, axes[1], tiled=True), axes[0],
                tiled=True)
            for x in xs)

    in_specs = tuple(P(axes, *([None] * (arrays[a].ndim - 1)))
                     for a in arrays)
    out_specs = tuple(P(*([None] * arrays[a].ndim)) for a in arrays)
    fn = jax.jit(jax.shard_map(gather_body, mesh=mesh, in_specs=in_specs,
                               out_specs=out_specs, check_vma=False))
    put = [jax.device_put(arrays[a], NamedSharding(mesh, s))
           for a, s in zip(arrays, in_specs)]
    gathered = fn(*put)
    g = {a: np.asarray(v) for a, v in zip(arrays, gathered)}
    genc = _EncodedEvents(**g)
    id2name = names
    for i in range(genc.valid.shape[0]):
        if genc.valid[i]:
            j, up, down = _decode_event(genc, i, id2name)
            insert_junction_event(jmap, j, up, down)


def spmd_build_junctions(mesh, clipfile: str, samfile: str,
                         skip_min_mapq: int = 0,
                         rescue: bool = False,
                         window_groups: int = 4096):
    """Junction-table construction with the event tables crossing the
    mesh: clip groups are split contiguously across shards, each shard
    generates its (pure, order-preserving) junction events
    (getsv.junction_event), the encoded 6-tuple+payload tables are
    all-gathered with jax.lax.all_gather, and the gathered stream is
    replayed in original order through the ordered-multimap accumulation
    (insert_junction_event).  Exact vs the sequential input_soft_info by
    construction; asserted by tests/test_spmd_pipeline.py.

    Groups stream through in windows of `window_groups` (VERDICT r3 #7:
    the getsv phase must not materialize the whole clip table as Python
    objects — the live set is one window; windows replay in clip.gz
    order so the multimap accumulation is identical to one big pass)."""
    jmap = JunctionMap()
    rescue_events: list = []
    window: list = []
    for g in iter_soft_groups(clipfile, samfile, skip_min_mapq):
        window.append(g)
        if len(window) >= window_groups:
            _gather_window(mesh, jmap, window, rescue, rescue_events)
            window = []
    if window:
        _gather_window(mesh, jmap, window, rescue, rescue_events)
    return jmap, rescue_events


# --------------------------------------------------------------------------
# MergeJunction, partitioned at safe cut points
# --------------------------------------------------------------------------

def _merge_pair_strings(ji, oi, jk, ok):
    """The four shifted sequences MergeJunction compares for a candidate
    pair (ref: getsv.cpp:1355-1410), or None when the pair can never
    merge (the `skip` / no-single-cigar branches).  Depends only on
    seq/cigar/positions — none of which the merge mutates — so the 0.85
    gate is precomputable for every pair before the stateful scan."""
    if len(oi.up.cigar) == 1 and len(ok.up.cigar) == 1:
        mh = jk[1] - ji[1]
        if ((ji[2] == "+" and len(ok.up.seq) < mh + 5)
                or (ji[2] == "-" and len(oi.up.seq) < mh + 5)):
            return None
        if ji[2] == "+":
            return (oi.up.seq, oi.down.seq,
                    ok.up.seq[: len(ok.up.seq) - mh],
                    ok.up.seq[len(ok.up.seq) - mh:] + ok.down.seq)
        return (oi.up.seq[: len(oi.up.seq) - mh],
                oi.up.seq[len(oi.up.seq) - mh:] + oi.down.seq,
                ok.up.seq, ok.down.seq)
    if len(oi.down.cigar) == 1 and len(ok.down.cigar) == 1:
        mh = abs(jk[4] - ji[4])
        if ((ji[2] == "+" and len(oi.down.seq) < mh + 5)
                or (ji[2] == "-" and len(ok.down.seq) < mh + 5)):
            return None
        if ji[2] == "+":
            return (oi.up.seq + oi.down.seq[:mh], oi.down.seq[mh:],
                    ok.up.seq, ok.down.seq)
        return (oi.up.seq, oi.down.seq,
                ok.up.seq + ok.down.seq[:mh], ok.down.seq[mh:])
    return None


def _enumerate_merge_pairs(items, lo: int, hi: int, search_length: int):
    """Candidate pairs (i, k) of one partition with their four shifted
    strings (state-independent — see _merge_pair_strings)."""
    pairs = []
    strs = []
    for i in range(lo, hi):
        ji, oi = items[i]
        if oi.up.rcl > 0 or oi.up.lcl > 0:
            continue
        for k in range(i + 1, hi):
            jk, ok = items[k]
            if jk[1] - ji[1] > search_length:
                break
            if abs(jk[4] - ji[4]) <= search_length and ok.down.lcl == 0:
                s = _merge_pair_strings(ji, oi, jk, ok)
                if s is not None:
                    pairs.append((i, k))
                    strs.append(s)
    return pairs, strs


def _batch_merge_gates(pairs, strs):
    """The 0.85 both-side match gate for EVERY candidate pair of every
    partition as one padded data-parallel comparison (the reference
    evaluates it pair-at-a-time, getsv.cpp:1411; this formulation is a
    single fused elementwise+reduce op — the array shape of the
    merge's compute)."""
    if not pairs:
        return {}
    LU = max(max(min(len(a), len(c)) for a, _b, c, _d in strs), 1)
    LD = max(max(min(len(b), len(d)) for _a, b, _c, d in strs), 1)
    P = len(pairs)
    # right-anchored (match_rate_end) for up, left-anchored for down
    u1 = np.zeros((P, LU), np.uint8)
    u2 = np.full((P, LU), 0xFF, np.uint8)
    d1 = np.zeros((P, LD), np.uint8)
    d2 = np.full((P, LD), 0xFF, np.uint8)
    nu = np.zeros(P, np.int32)
    nd = np.zeros(P, np.int32)
    for p, (a, b, c, d) in enumerate(strs):
        n1 = min(len(a), len(c))
        if n1:
            u1[p, :n1] = np.frombuffer(a[len(a) - n1:], np.uint8)
            u2[p, :n1] = np.frombuffer(c[len(c) - n1:], np.uint8)
        nu[p] = n1
        n2 = min(len(b), len(d))
        if n2:
            d1[p, :n2] = np.frombuffer(b[:n2], np.uint8)
            d2[p, :n2] = np.frombuffer(d[:n2], np.uint8)
        nd[p] = n2
    mu = (u1 == u2).sum(axis=1).astype(np.float64)
    md = (d1 == d2).sum(axis=1).astype(np.float64)
    # the same float64 division-then-compare as match_rate_end/begin (and
    # the C++, clip_reads.cpp:194-217); n == 0 reproduces the
    # NaN-compares-false semantics
    with np.errstate(invalid="ignore", divide="ignore"):
        gate = ((nu > 0) & (nd > 0)
                & (mu / nu >= 0.85) & (md / nd >= 0.85))
    return {pk: bool(g) for pk, g in zip(pairs, gate)}


def _merge_partition_gated(items, lo: int, hi: int, search_length: int,
                           gates) -> List[tuple]:
    """The sequential MergeJunction scan of one partition with the 0.85
    gate looked up from the precomputed table (state transitions —
    support/uniq/mh accumulation, survivor priority, deletions — are
    byte-identical to pipeline.getsv.merge_junction; gate keys are
    original item indices, which deletions never invalidate because the
    window conditions test values, not positions)."""
    sub = [list(t) + [idx] for idx, t in enumerate(items[lo:hi], start=lo)]
    i = 0
    while i < len(sub):
        ji, oi, id_i = sub[i]
        if oi.up.rcl > 0 or oi.up.lcl > 0:
            i += 1
            continue
        k = i + 1
        mark = False
        while (k < len(sub)
               and ji[0] == sub[k][0][0] and ji[3] == sub[k][0][3]
               and ji[2] == sub[k][0][2] and ji[5] == sub[k][0][5]
               and sub[k][0][1] - ji[1] <= search_length):
            jk, ok, id_k = sub[k]
            if abs(jk[4] - ji[4]) <= search_length and ok.down.lcl == 0:
                if gates.get((id_i, id_k), False):
                    oi.up.uniq = max(oi.up.uniq, ok.up.uniq)
                    oi.down.uniq = max(oi.down.uniq, ok.down.uniq)
                    if oi.mh == -1 and ok.mh == -1:
                        oi.up.support += ok.up.support
                        oi.down.support += ok.down.support
                        if ((oi.up.support != 0 and ok.down.support != 0)
                                or (oi.down.support != 0
                                    and ok.up.support != 0)):
                            oi.mh = jk[1] - ji[1]
                        del sub[k]
                    elif oi.mh != -1 and ok.mh == -1:
                        oi.up.support += ok.up.support
                        oi.down.support += ok.down.support
                        del sub[k]
                    elif oi.mh == -1 and ok.mh != -1:
                        ok.up.support += oi.up.support
                        ok.down.support += oi.down.support
                        mark = True
                    else:
                        if (oi.up.support > ok.up.support
                                or oi.down.support == ok.down.support):
                            oi.up.support += ok.up.support
                            del sub[k]
                        elif (oi.up.support == ok.up.support
                                or oi.down.support > ok.down.support):
                            oi.down.support += ok.down.support
                            del sub[k]
                        elif (ok.up.support > oi.up.support
                                and oi.down.support == ok.down.support):
                            ok.up.support += oi.up.support
                            mark = True
                        elif (ok.down.support > oi.down.support
                                and ok.up.support == oi.up.support):
                            ok.down.support += oi.down.support
                            mark = True
                        else:
                            k += 1
                    if mark:
                        break
                else:
                    k += 1
            else:
                k += 1
        if mark:
            del sub[i]
        else:
            i += 1
    return [(j, o) for j, o, _id in sub]


def merge_junction_sharded(jmap: JunctionMap, search_length: int,
                           max_workers: int = 0) -> int:
    """Partitioned MergeJunction (ref: getsv.cpp:1325-1482): the merge
    scan from item i only reaches items k with identical
    (up_chr, down_chr, up_strand, down_strand) and
    up_pos[k] - up_pos[i] <= search_length, so cutting the key-sorted
    table where the prefix changes or the up_pos gap exceeds
    search_length yields fully independent partitions.  The parallelism
    is realized in the GATE phase: every partition's 0.85 match
    comparisons (the merge's compute, >90% of its work) evaluate as ONE
    padded data-parallel batched op.  The cheap stateful replays then
    run per partition on a thread pool — independent and safe, though on
    CPython they interleave under the GIL rather than speed up
    (scripts/bench_merge.py reports the interleaving honestly; true
    replay parallelism needs free-threading or processes).  Exact vs the
    sequential pass — asserted by tests/test_spmd_pipeline.py.  Returns
    the number of partitions (the available parallelism)."""
    import concurrent.futures as cf
    import os

    items = jmap.items
    n = len(items)
    if n == 0:
        return 0
    cuts = [0]
    for idx in range(1, n):
        a = items[idx - 1][0]
        b = items[idx][0]
        if ((a[0], a[3], a[2], a[5]) != (b[0], b[3], b[2], b[5])
                or b[1] - a[1] > search_length):
            cuts.append(idx)
    cuts.append(n)
    spans = list(zip(cuts, cuts[1:]))

    # Phase 1 — the match-gate compute for every pair of every partition
    # as ONE data-parallel batched comparison (>90% of the merge's work).
    all_pairs: list = []
    all_strs: list = []
    for lo, hi in spans:
        p, s = _enumerate_merge_pairs(items, lo, hi, search_length)
        all_pairs.extend(p)
        all_strs.extend(s)
    gates = _batch_merge_gates(all_pairs, all_strs)

    # Phase 2 — the cheap stateful replays, independent per partition,
    # on a thread pool (chunked so each task is big enough to overlap).
    def run(span):
        lo, hi = span
        return _merge_partition_gated(items, lo, hi, search_length, gates)

    if max_workers <= 0:
        max_workers = min(8, os.cpu_count() or 1)
    if max_workers > 1 and len(spans) > 1:
        with cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
            merged_parts = list(ex.map(run, spans))
    else:
        merged_parts = [run(s) for s in spans]
    new = JunctionMap()
    for part in merged_parts:
        for j, o in part:
            new.insert(j, o)
    jmap.keys = new.keys
    jmap.items = new.items
    jmap._seq = new._seq
    return len(spans)


# --------------------------------------------------------------------------
# insert-size + coverage (one shard_map step), discordant windows (second)
# --------------------------------------------------------------------------

HIST_SIZE = 1 << 16


def _coverage_insert_body(dp: int, block: int, g_pad: int,
                          read_pair_used: int, ax_dp: str, ax_gp: str):
    """The shard_map body shared by the single-process SPMD step and the
    multi-process (jax.distributed) step: coverage scatter-add + psum over
    dp, genome axis sharded over gp; insert-size first-N mask via a
    cross-shard prefix count + histogram psum."""
    import jax
    import jax.numpy as jnp

    def body(st, en, isz, okm, ovm):
        # coverage: local scatter-add on the diff array, psum over dp,
        # cumsum, slice my gp block (sequence parallel over coordinates)
        diff = jnp.zeros(g_pad + 1, jnp.int32)
        diff = diff.at[jnp.clip(st, 0, g_pad)].add(1)
        diff = diff.at[jnp.clip(en, 0, g_pad)].add(-1)
        diff = jax.lax.psum(diff, ax_dp)
        cov = jnp.cumsum(diff)[:g_pad]
        gp_idx = jax.lax.axis_index(ax_gp)
        cov_local = jax.lax.dynamic_slice(cov, (gp_idx * block,), (block,))

        # insert-size: global first-N mask via cross-shard prefix count
        cnt = jnp.sum(okm.astype(jnp.int32))
        cnts = jax.lax.all_gather(cnt, ax_dp)            # [dp]
        dp_idx = jax.lax.axis_index(ax_dp)
        offset = jnp.sum(jnp.where(jnp.arange(dp) < dp_idx, cnts, 0))
        local_rank = jnp.cumsum(okm.astype(jnp.int32)) - 1
        take = okm & (offset + local_rank < read_pair_used)
        hist = jnp.zeros(HIST_SIZE, jnp.int32)
        hist = hist.at[isz].add(take.astype(jnp.int32))
        hist = jax.lax.psum(hist, ax_dp)
        n_over = jax.lax.psum(jnp.sum((take & ovm).astype(jnp.int32)),
                              ax_dp)
        return cov_local, hist, n_over[None]

    return body


def _flat_segments(recs: BamRecords, min_mapq: int, offsets: np.ndarray,
                   g_pad: int):
    """Depth segments in genome-flat coordinates (host prep shared by the
    SPMD and multi-process steps).  Native single-pass when built (the
    numpy form below is the oracle — identical output asserted by the
    SPMD-vs-sequential coverage parity tests)."""
    from ..io import native
    if native.depth_segments_flat_available():
        return native.depth_segments_flat(recs, min_mapq, offsets)
    seg_start, seg_end, seg_tid = depth_segments(recs, min_mapq)
    # clip per-tid (a segment overhanging its chromosome end must not
    # bleed into the next tid's block in the flat coordinate space)
    tid_lens = np.asarray(recs.ref_lens, np.int64)[seg_tid]
    seg_start = np.clip(seg_start, 0, tid_lens)
    seg_end = np.clip(seg_end, 0, tid_lens)
    flat_start = (seg_start + offsets[seg_tid]).astype(np.int64)
    flat_end = (seg_end + offsets[seg_tid]).astype(np.int64)
    return flat_start, flat_end


def _insert_columns(recs: BamRecords, min_mapq: int):
    """Per-record first-N qualification mask + clamped isize columns
    (ref cluster.cpp:25-56)."""
    first_op = recs.first_op()
    last_op = recs.last_op()
    has_cigar = recs.cig_off[1:] > recs.cig_off[:-1]
    hard = has_cigar & ((first_op == OP_H) | (last_op == OP_H))
    from ..io.bam import FPAIRED, FPROPER_PAIR
    ok = ((recs.mapq >= min_mapq)
          & ((recs.flag & FPAIRED) != 0) & ((recs.flag & FPROPER_PAIR) != 0)
          & ((recs.flag & FDUP) == 0) & (recs.isize > 0) & ~hard)
    isize = np.clip(recs.isize, 0, HIST_SIZE - 1).astype(np.int32)
    over = np.asarray(recs.isize >= HIST_SIZE)
    return ok, isize, over


def _insert_stats_from_hist(hist: np.ndarray, extra_vals=()):
    """Exact integer mean + truncated-int deviation (cluster.cpp:15-83)
    from the device histogram, plus any host-spilled overflow values
    (isize >= HIST_SIZE; rare but legal — the histogram rows for them
    are clamped on-device and replaced by their exact values here)."""
    extra = np.asarray(list(extra_vals), np.int64)
    n = int(hist.sum()) + len(extra)
    if n == 0:
        return 0, 0
    vals = np.arange(HIST_SIZE, dtype=np.int64)
    mean = int(((hist * vals).sum() + extra.sum()) // n)
    import math
    ss = float((hist * (vals - mean) ** 2).sum()) \
        + float(((extra - mean).astype(np.float64) ** 2).sum())
    dev = int(math.sqrt(ss / n))
    return mean, dev


def spmd_coverage_insert(mesh, recs: BamRecords, min_mapq: int,
                         read_pair_used: int):
    """One jitted shard_map step over the real record arrays:
      * coverage — M/=/X segments (depth_segments) sharded over dp,
        scatter-added locally, psum over dp, genome axis sharded over gp;
      * insert-size — the first-N proper-pair mask via a cross-shard
        prefix count (all_gather over dp) + histogram psum.
    Returns (cov: {tid: np.ndarray}, mean, dev) with the exact integer
    semantics of cluster.cpp:15-83 / bam2depth.cpp:75-129."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    dp = mesh.shape[mesh.axis_names[0]]
    gp = mesh.shape[mesh.axis_names[1]]

    # genome-flat coordinate space
    offsets = np.concatenate([[0], np.cumsum(recs.ref_lens)]).astype(np.int64)
    g_total = int(offsets[-1])
    block = -(-(g_total + 1) // gp)
    g_pad = block * gp

    flat_start, flat_end = _flat_segments(recs, min_mapq, offsets, g_pad)
    S = len(flat_start)
    Sp = -(-max(S, 1) // dp) * dp
    starts = np.full(Sp, g_pad, np.int64)
    ends = np.full(Sp, g_pad, np.int64)
    starts[:S] = flat_start
    ends[:S] = flat_end

    ok, isize_c, over_c = _insert_columns(recs, min_mapq)
    N = recs.n
    Npad = -(-max(N, 1) // dp) * dp
    isize = np.zeros(Npad, np.int32)
    okp = np.zeros(Npad, bool)
    over = np.zeros(Npad, bool)
    isize[:N] = isize_c
    over[:N] = over_c
    okp[:N] = ok

    ax_dp, ax_gp = mesh.axis_names
    body = _coverage_insert_body(dp, block, g_pad, read_pair_used,
                                 ax_dp, ax_gp)
    fn = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(ax_dp), P(ax_dp), P(ax_dp), P(ax_dp), P(ax_dp)),
        out_specs=(P(ax_gp), P(None), P(None)), check_vma=False))
    put = lambda a: jax.device_put(a, NamedSharding(mesh, P(ax_dp)))
    cov, hist, n_over = fn(put(starts), put(ends), put(isize), put(okp),
                           put(over))
    cov = np.asarray(cov)[:g_total]
    hist = np.asarray(hist).astype(np.int64)
    extra = ()
    if int(np.asarray(n_over)[0]):
        # isize >= HIST_SIZE spill (VERDICT r2: the mesh path must not be
        # less robust than the host path): those records were clamped
        # into the top bin on-device; replace them with their exact
        # host-side values under the same global first-N mask
        rank = np.cumsum(ok) - 1
        taken_over = ok & over_c & (rank < read_pair_used)
        extra = np.asarray(recs.isize)[taken_over].astype(np.int64)
        assert len(extra) == int(np.asarray(n_over)[0])
        hist[HIST_SIZE - 1] -= len(extra)
    mean, dev = _insert_stats_from_hist(hist, extra)
    cov_by_tid = {t: cov[offsets[t]:offsets[t + 1]].astype(np.int32)
                  for t in range(len(recs.ref_names))}
    return cov_by_tid, mean, dev


def multiprocess_coverage_insert(mesh, local_recs: BamRecords,
                                 min_mapq: int, read_pair_used: int):
    """The multi-HOST form of spmd_coverage_insert (SURVEY.md §2
    communication call-out: per-host file sharding +
    jax.make_array_from_process_local_data): every process supplies only
    its own contiguous slice of the BAM's records — no process ever sees
    the whole file — and the cross-shard prefix count inside the shard_map
    body reconstructs the global first-N insert-size mask exactly.

    Requires jax.distributed to be initialized and the mesh's dp axis to
    enumerate processes in file order (process p holds the p-th record
    range).  Returns (cov_by_tid, mean, dev), identical to the
    single-process pass — asserted by tests/test_multihost.py."""
    import jax
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    ax_dp, ax_gp = mesh.axis_names
    dp = mesh.shape[ax_dp]
    gp = mesh.shape[ax_gp]

    offsets = np.concatenate(
        [[0], np.cumsum(local_recs.ref_lens)]).astype(np.int64)
    g_total = int(offsets[-1])
    block = -(-(g_total + 1) // gp)
    g_pad = block * gp

    flat_start, flat_end = _flat_segments(local_recs, min_mapq, offsets,
                                          g_pad)
    ok, isize_c, over_c = _insert_columns(local_recs, min_mapq)

    # agree on the per-DEVICE padded shard sizes (control-plane exchange;
    # the record data itself never leaves its process).  A process with
    # n_local_dev devices contributes n_local_dev contiguous dp shards:
    # its local arrays are padded to n_local_dev * per_dev and split
    # evenly, preserving record order across the dp axis.
    n_local_dev = max(1, jax.local_device_count())
    counts = np.asarray(multihost_utils.process_allgather(np.asarray(
        [-(-max(len(flat_start), 1) // n_local_dev),
         -(-max(local_recs.n, 1) // n_local_dev)], np.int64)))
    counts = counts.reshape(-1, 2)
    S_dev = int(counts[:, 0].max(initial=1))
    N_dev = int(counts[:, 1].max(initial=1))

    def pad_local(a, per_dev, fill):
        out = np.full(n_local_dev * per_dev, fill, a.dtype)
        out[:len(a)] = a
        return out

    sh = NamedSharding(mesh, P(ax_dp))
    mk = jax.make_array_from_process_local_data
    gstarts = mk(sh, pad_local(flat_start, S_dev, np.int64(g_pad)))
    gends = mk(sh, pad_local(flat_end, S_dev, np.int64(g_pad)))
    gisize = mk(sh, pad_local(isize_c, N_dev, np.int32(0)))
    gok = mk(sh, pad_local(np.asarray(ok), N_dev, False))
    gover = mk(sh, pad_local(over_c, N_dev, False))

    body = _coverage_insert_body(dp, block, g_pad, read_pair_used,
                                 ax_dp, ax_gp)
    fn = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(ax_dp), P(ax_dp), P(ax_dp), P(ax_dp), P(ax_dp)),
        out_specs=(P(ax_gp), P(None), P(None)), check_vma=False))
    cov, hist, n_over = fn(gstarts, gends, gisize, gok, gover)
    # outputs are replicated over dp -> locally addressable everywhere
    cov = np.asarray(cov.addressable_data(0))
    hist = np.asarray(hist.addressable_data(0)).astype(np.int64)
    extra = ()
    if int(np.asarray(n_over.addressable_data(0))[0]):
        # isize >= HIST_SIZE spill across processes: reconstruct the
        # global first-N mask for the (rare) overflow records from the
        # per-dp-shard qualifying counts, then allgather their exact
        # values (tiny control-plane exchange; record data stays local)
        okp_l = pad_local(np.asarray(ok), N_dev, False)
        isz_l = pad_local(np.asarray(local_recs.isize, np.int64), N_dev,
                          np.int64(0))
        ovr_l = pad_local(over_c, N_dev, False)
        shard_ok = okp_l.reshape(n_local_dev, N_dev)
        shard_counts = shard_ok.sum(axis=1).astype(np.int64)
        all_counts = np.asarray(multihost_utils.process_allgather(
            shard_counts)).reshape(-1)  # dp order = (process, shard)
        base = np.concatenate([[0], np.cumsum(all_counts)])[:-1]
        my_first = jax.process_index() * n_local_dev
        vals = []
        for d in range(n_local_dev):
            rank = np.cumsum(shard_ok[d]) - 1
            take = (shard_ok[d]
                    & ovr_l.reshape(n_local_dev, N_dev)[d]
                    & (base[my_first + d] + rank < read_pair_used))
            vals.extend(isz_l.reshape(n_local_dev, N_dev)[d][take])
        cnts = np.asarray(multihost_utils.process_allgather(
            np.asarray([len(vals)], np.int64))).reshape(-1)
        cap = int(cnts.max(initial=0))
        padded = np.full(cap, -1, np.int64)
        padded[:len(vals)] = vals
        allv = np.asarray(multihost_utils.process_allgather(
            padded)).reshape(len(cnts), cap) if cap else \
            np.zeros((len(cnts), 0), np.int64)
        extra = np.concatenate(
            [allv[p, :cnts[p]] for p in range(len(cnts))]) \
            if cap else np.zeros(0, np.int64)
        hist[HIST_SIZE - 1] -= len(extra)
    mean, dev = _insert_stats_from_hist(hist, extra)
    cov_by_tid = {t: cov[offsets[t]:offsets[t + 1]].astype(np.int32)
                  for t in range(len(local_recs.ref_names))}
    return cov_by_tid, mean, dev


def spmd_discordant_counts(mesh, counter: DiscordantCounter,
                           junctions) -> np.ndarray:
    """Discordant-pair support on the mesh: junction windows sharded over
    all devices, records replicated (the at-scale variant shards records
    over gp by coordinate with mean+4σ halos, SURVEY.md §5), counted with
    ops.jax_kernels.discordant_count_batch."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..ops.jax_kernels import discordant_count_batch

    recs = counter.recs
    J = len(junctions)
    if J == 0:
        return np.zeros(0, np.int32)
    K = 5
    lo = np.zeros(J, np.int64)
    hi = np.zeros(J, np.int64)
    beg = np.zeros(J, np.int64)
    upv = np.zeros(J, np.int64)
    dnv = np.zeros(J, np.int64)
    dtid = np.full(J, -1, np.int32)
    stid = np.zeros(J, bool)
    code = np.zeros(J, np.int32)
    for i, j in enumerate(junctions):
        up_chr, up_pos, us, down_chr, down_pos, ds = j
        tid = counter.name2tid.get(up_chr, -1)
        mtid = counter.name2tid.get(down_chr, -1)
        if tid == -1 or (us, ds) not in (("+", "+"), ("-", "+"), ("+", "-")):
            continue
        chr_len = counter.ref_lens[tid]
        if us == "+":
            end_w = up_pos
            beg_w = end_w - counter.max_insert
        else:
            beg_w = up_pos - 1 - K
            end_w = up_pos - 1 + counter.max_insert
        if beg_w <= 0:
            beg_w = 1
        if end_w > chr_len:
            end_w = chr_len
        rng = counter.tid_ranges.get(tid)
        if rng is None or end_w <= beg_w or mtid == -1:
            continue
        tlo, thi = rng
        posv = counter.pos64[tlo:thi]
        h2 = tlo + int(np.searchsorted(posv, end_w, "left"))
        l2 = tlo + int(np.searchsorted(
            posv, beg_w - counter.tid_max_span[tid], "right"))
        lo[i], hi[i] = min(l2, h2), h2
        beg[i] = beg_w
        upv[i], dnv[i] = up_pos, down_pos
        dtid[i] = mtid
        stid[i] = tid == mtid
        code[i] = {("+", "+"): 0, ("-", "+"): 1, ("+", "-"): 2}[(us, ds)]

    wmax = int(np.max(hi - lo)) if J else 0
    window_cap = 1 << max(int(np.ceil(np.log2(max(wmax, 1)))), 6)
    ndev = mesh.size
    Jp = -(-J // ndev) * ndev
    pad = lambda a: np.concatenate(
        [a, np.zeros(Jp - J, a.dtype)]) if Jp > J else a

    axes = tuple(mesh.axis_names)
    repl = NamedSharding(mesh, P())
    shrd = NamedSharding(mesh, P(axes))
    flag = recs.flag
    rec_arrays = [np.asarray(recs.pos), np.asarray(counter.end),
                  np.asarray(recs.l_qseq), np.asarray(recs.mpos),
                  np.asarray(recs.mtid), (flag & FREVERSE) == 0,
                  (flag & FMREVERSE) == 0, counter.base_ok]
    jun_arrays = [pad(a) for a in (lo, hi, beg, upv, dnv, dtid, stid, code)]
    mins = np.full(Jp, counter.min_insert, np.int64)
    maxs = np.full(Jp, counter.max_insert, np.int64)

    def body(*args):
        ra = args[:8]
        ja = args[8:]
        return discordant_count_batch(*ra, *ja, window_cap=window_cap)

    in_specs = tuple([P()] * 8 + [P(axes)] * 10)
    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=in_specs,
                               out_specs=P(axes), check_vma=False))
    put_r = [jax.device_put(a, repl) for a in rec_arrays]
    put_j = [jax.device_put(a, shrd) for a in jun_arrays + [mins, maxs]]
    counts = np.asarray(fn(*put_r, *put_j))
    return counts[:J]


def spmd_discordant_counts_sharded(mesh, counter: DiscordantCounter,
                                   junctions) -> np.ndarray:
    """Coordinate-sharded discordant counting (VERDICT r2 item 5;
    SURVEY.md §5): records are SHARDED across devices by coordinate
    blocks instead of replicated — each device receives only the record
    slice its junction windows touch.  Junctions sort by window start and
    split contiguously over devices; a device's record slice is the union
    span of its windows, i.e. its coordinate block plus the
    mean+4σ+max_span halo the windows reach back by (ref window bound
    getsv.cpp:1032).  Value-equal to the replicated
    spmd_discordant_counts (tests/test_spmd_pipeline.py).

    Per-device memory: ~26 B x (n_records/ndev + halo_records) for the
    LightBam columns instead of 26 B x n_records — at 900M records
    (30x human WGS) that is ~2.9 GB/device on 8 devices (plus a few MB
    of halo at 30x coverage: halo ≈ coverage x (mean+4σ)/read_len ≈
    1k records) instead of ~23 GB/device replicated."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..ops.jax_kernels import discordant_count_batch

    recs = counter.recs
    J = len(junctions)
    if J == 0:
        return np.zeros(0, np.int32)
    if mesh.size == 1:
        # degenerate mesh: no shard to route to — the host counter IS
        # the single-device computation without the pad/upload round
        # trip (value-equal; the >=2-device path is the memory form)
        return np.asarray([counter.count(j) for j in junctions], np.int64)
    K = 5
    # per-junction global window record ranges (same prep as the
    # replicated form)
    lo = np.zeros(J, np.int64)
    hi = np.zeros(J, np.int64)
    beg = np.zeros(J, np.int64)
    upv = np.zeros(J, np.int64)
    dnv = np.zeros(J, np.int64)
    dtid = np.full(J, -1, np.int32)
    stid = np.zeros(J, bool)
    code = np.full(J, -1, np.int32)
    for i, j in enumerate(junctions):
        up_chr, up_pos, us, down_chr, down_pos, ds = j
        tid = counter.name2tid.get(up_chr, -1)
        mtid = counter.name2tid.get(down_chr, -1)
        if tid == -1 or (us, ds) not in (("+", "+"), ("-", "+"), ("+", "-")):
            continue
        chr_len = counter.ref_lens[tid]
        if us == "+":
            end_w = up_pos
            beg_w = end_w - counter.max_insert
        else:
            beg_w = up_pos - 1 - K
            end_w = up_pos - 1 + counter.max_insert
        if beg_w <= 0:
            beg_w = 1
        if end_w > chr_len:
            end_w = chr_len
        rng = counter.tid_ranges.get(tid)
        if rng is None or end_w <= beg_w or mtid == -1:
            continue
        tlo, thi = rng
        posv = counter.pos64[tlo:thi]
        h2 = tlo + int(np.searchsorted(posv, end_w, "left"))
        l2 = tlo + int(np.searchsorted(
            posv, beg_w - counter.tid_max_span[tid], "right"))
        lo[i], hi[i] = min(l2, h2), h2
        beg[i] = beg_w
        upv[i], dnv[i] = up_pos, down_pos
        dtid[i] = mtid
        stid[i] = tid == mtid
        code[i] = {("+", "+"): 0, ("-", "+"): 1, ("+", "-"): 2}[(us, ds)]

    ndev = mesh.size
    active = np.nonzero(code >= 0)[0]
    counts = np.zeros(J, np.int32)
    if len(active) == 0:
        return counts
    # contiguous split of window-start-sorted junctions over devices
    order = active[np.argsort(lo[active], kind="stable")]
    bounds = np.linspace(0, len(order), ndev + 1).astype(int)
    Jcap = max(int(np.max(bounds[1:] - bounds[:-1])), 1)
    # per-device record slice = union span of its windows
    s_lo = np.zeros(ndev, np.int64)
    s_hi = np.zeros(ndev, np.int64)
    for d in range(ndev):
        sel = order[bounds[d]:bounds[d + 1]]
        if len(sel):
            s_lo[d] = lo[sel].min()
            s_hi[d] = hi[sel].max()
    Rcap = max(int(np.max(s_hi - s_lo)), 1)
    wmax = int(np.max((hi - lo)[active])) if len(active) else 0
    window_cap = 1 << max(int(np.ceil(np.log2(max(wmax, 1)))), 6)

    flag = recs.flag
    fwd_a = (flag & FREVERSE) == 0
    mfwd_a = (flag & FMREVERSE) == 0
    col_src = dict(pos=np.asarray(recs.pos), end=np.asarray(counter.end),
                   lq=np.asarray(recs.l_qseq), mpos=np.asarray(recs.mpos),
                   mtid=np.asarray(recs.mtid), fwd=fwd_a, mfwd=mfwd_a,
                   base_ok=np.asarray(counter.base_ok))
    rec_cols = {k: np.zeros((ndev, Rcap), v.dtype)
                for k, v in col_src.items()}
    jun_cols = {k: np.zeros((ndev, Jcap), a.dtype)
                for k, a in (("lo", lo), ("hi", hi), ("beg", beg),
                             ("upv", upv), ("dnv", dnv), ("dtid", dtid),
                             ("stid", stid), ("code", code))}
    mins = np.full((ndev, Jcap), counter.min_insert, np.int64)
    maxs = np.full((ndev, Jcap), counter.max_insert, np.int64)
    jid = np.full((ndev, Jcap), -1, np.int64)
    for d in range(ndev):
        a, b = int(s_lo[d]), int(s_hi[d])
        for k, v in col_src.items():
            rec_cols[k][d, :b - a] = v[a:b]
        sel = order[bounds[d]:bounds[d + 1]]
        for c, i in enumerate(sel):
            # window indices rebased into the shard's slice
            jun_cols["lo"][d, c] = lo[i] - a
            jun_cols["hi"][d, c] = hi[i] - a
            jun_cols["beg"][d, c] = beg[i]
            jun_cols["upv"][d, c] = upv[i]
            jun_cols["dnv"][d, c] = dnv[i]
            jun_cols["dtid"][d, c] = dtid[i]
            jun_cols["stid"][d, c] = stid[i]
            jun_cols["code"][d, c] = code[i]
            jid[d, c] = i
        # padding rows: empty windows (lo == hi == 0) count 0

    axes = tuple(mesh.axis_names)
    sh = NamedSharding(mesh, P(axes, None))

    def body(*args):
        ra = [a[0] for a in args[:8]]
        ja = [a[0] for a in args[8:]]
        return discordant_count_batch(*ra, *ja,
                                      window_cap=window_cap)[None]

    in_specs = tuple([P(axes, None)] * 18)
    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=in_specs,
                               out_specs=P(axes, None), check_vma=False))
    put = lambda a: jax.device_put(a, sh)
    out = np.asarray(fn(
        *[put(rec_cols[k]) for k in ("pos", "end", "lq", "mpos", "mtid",
                                     "fwd", "mfwd", "base_ok")],
        *[put(jun_cols[k]) for k in ("lo", "hi", "beg", "upv", "dnv",
                                     "dtid", "stid", "code")],
        put(mins), put(maxs)))
    for d in range(ndev):
        for c in range(Jcap):
            if jid[d, c] >= 0:
                counts[jid[d, c]] = out[d, c]
    return counts


# --------------------------------------------------------------------------
# full getsv + pipeline orchestration
# --------------------------------------------------------------------------

def spmd_getsv(mesh, clip_sam: str, original_bam: str, clipfile: str,
               sv_out: str, rescue_fq_out: str, *, flank: int = 50,
               min_mapq: int = 20, read_pair_used: int = 5_000_000,
               sum_min_both_clip: int = 3, min_distance: int = 50,
               min_abnormal: int = 0, frequency: float = 0.1,
               max_microhomology: int = 50, min_seq_len: int = 30,
               max_seq_indel_no: int = 1, flank_length: int = 200,
               output_depth: bool = True, times: int = 4,
               filtered_out=None, recs: Optional[BamRecords] = None,
               rescue: bool = False, rescue_mode: bool = True,
               min_one_side_clip: int = 5, max_repeat_depth: int = 500,
               log=lambda *a: None) -> None:
    """getsv with every numeric stage on the mesh (see module docstring);
    value-identical to pipeline.getsv.getsv."""
    import io
    import sys

    if filtered_out is None:
        filtered_out = sys.stdout
    jmap, rescue_events = spmd_build_junctions(mesh, clipfile, clip_sam,
                                               0, rescue)
    log("'spmd junction all-gather' finished")
    nparts = merge_junction_sharded(jmap, flank)
    log(f"'merge_junction_sharded' finished ({nparts} partitions)")

    if recs is None:
        recs = read_bam(original_bam)

    cov, mean, dev = spmd_coverage_insert(mesh, recs, min_mapq,
                                          read_pair_used)
    if read_pair_used >= 100_000:
        log(f"Mean insert size: {mean}; deviation: {dev}")
        counter = DiscordantCounter(recs, min_mapq, mean, dev, times)
        # coordinate-sharded (halo'd) record sharding is the production
        # form — per-device memory n/ndev + halo instead of full
        # replication (the replicated form remains for A/B validation)
        counts = spmd_discordant_counts_sharded(
            mesh, counter, [j for j, _ in jmap.items])
        for (j, o), c in zip(jmap.items, counts):
            o.abnormal = int(c)
        log("'spmd discordant' finished")
    else:
        min_abnormal = 0  # ref: seeksv.cpp:284-286

    depth = None
    if output_depth:
        depth = DepthQuery(recs, min_mapq, cov=cov)
        log("'spmd coverage' finished")
    else:
        frequency = 0.0  # ref: seeksv.cpp:298-301

    with open(sv_out, "w") as fout:
        fout.write(SV_HEADER + "\n")
        output_breakpoints(jmap, depth, flank_length, sum_min_both_clip,
                           min_abnormal, frequency, min_distance,
                           max_microhomology, min_seq_len, max_seq_indel_no,
                           fout, filtered_out, rescue_mode,
                           min_one_side_clip, max_repeat_depth)
    with open(rescue_fq_out, "w") as fq:
        for _pos_key, cr in rescue_events:
            if cr.type == "n":
                fq.write(f"@{cr.clipped_seq.decode()}\n"
                         f"{cr.clipped_seq.decode()}\n+\n"
                         f"{cr.clipped_qual.decode()}\n")


def spmd_run_pipeline(mesh, ref_fa: str, bam: str, prefix: str,
                      log=lambda *a: None,
                      force_device_extend: bool = False) -> str:
    """Full pipeline (getclip → realign → getsv) with the compute stages
    executed SPMD on the given mesh.  Returns the sv file path.

    Extension batches route through the MEASURED dispatch calibration
    (align/dispatch_calibration.json): sub-crossover batches run on the
    host kernels even with the mesh attached.  force_device_extend=True
    overrides the calibration — the dryrun/test knob that keeps the
    mesh-sharded extension kernels exercised on CPU device meshes."""
    import io

    from ..align.engine import BatchAligner
    from ..pipeline.driver import write_sam, _read_fastq

    recs = read_bam(bam)
    spmd_getclip(mesh, bam, prefix, recs=recs)
    log("spmd getclip done")
    aligner = BatchAligner.from_fasta(ref_fa)
    aligner.shard_mesh = mesh
    seqs, quals = _read_fastq(f"{prefix}.clip.fq.gz")
    alns = aligner.batch_align(seqs, force_device=force_device_extend)
    write_sam(aligner, seqs, quals, alns, f"{prefix}.clip.sam")
    log("spmd realign done")
    spmd_getsv(mesh, f"{prefix}.clip.sam", bam, f"{prefix}.clip.gz",
               f"{prefix}.sv", f"{prefix}.unmapped.clip.fq", recs=recs,
               filtered_out=io.StringIO(), log=log)
    log(f"spmd getsv done -> {prefix}.sv")
    return f"{prefix}.sv"
