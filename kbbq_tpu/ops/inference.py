"""Pass-3 JAX kernel: batched Lighter-style error inference (D7).

Bit-exact twin of oracle/lighter.py::infer_read_errors, reformulated for
SIMD hardware (SURVEY.md H2) as a ROUND-BASED sweep:

The oracle's walk is sequential per read, but between "breaks" (a valid,
untrusted window) it only advances through windows whose trust is already
known.  So the batch kernel keeps an *effective trust* array [B, n]
(initialized from one vectorized filter query) and runs a `lax.while_loop`
over ROUNDS of full-batch state, where each round handles exactly one
break per active read:

  1. find each read's current break vectorized (first valid window with
     effective-trust false at-or-after the read's cursor) — no filter
     access;
  2. build all 4 substitution candidates for the k affected windows by
     PATCHING the window k-mer lane arrays in place (replacing the base at
     window offset d is a masked-OR at bit 2(k-1-d) of the forward word
     and bit 2d of the RC word — O(1) per window, no re-rolling);
  3. ONE batched blocked-Bloom word query [B, 4, W] (W = ext cap, D7) —
     the only filter access of the round;
  4. resolve extensions/tie-breaks, commit the chosen substitution into
     the lane state and working sequence, update effective trust for the
     k re-queried windows, jump the cursor to the next break.

Round count = max marked-error events over the batch (+1), vs the previous
vmapped-per-read while_loop that paid a full-batch [4,k,probes] gather per
*window advance* of the worst lane (~125x more filter traffic on E.-coli-
like data).

The LEFT walk is the RIGHT walk run on the reverse complement: canonical
k-mers are strand-invariant, so window trust is preserved under RC; the RC
lane state is the flipped (rc, fwd) lane pair and the RC effective-trust
array is the flipped one — commits made by the right walk carry over for
free.  The candidate tie-break order is reversed (RC code 3-c) to keep
first-max tie-breaking identical to the oracle's ascending-original order.

Breaks can only land on valid (N-free) windows by construction, which
subsumes the oracle's explicit N-window skips (they never mark anything).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .bloom import bloom_query_rows
from .kmers import canonical_from_lanes, canonical_kmers_batch, \
    kmer_lanes_batch

_i32 = jnp.int32
_u32 = jnp.uint32


def _complement(x: jax.Array) -> jax.Array:
    """Base complement, N (4) fixed (arithmetic: no table gather)."""
    return jnp.where(x < 4, 3 - x, x).astype(jnp.int8)


def _leading_true(x: jax.Array) -> jax.Array:
    """Count of leading True along the last axis (int32)."""
    return jnp.sum(jnp.cumprod(x.astype(_i32), axis=-1), axis=-1)


def _longest_run_anchors(trusted: jax.Array):
    """Batched longest-True-run (ties -> leftmost): (a, b, has) each [B].

    Matches oracle _longest_true_run.  run[i] = i - (index of last False
    at or before i) — a single cummax instead of a length-n scan (the
    scan emitted n sub-us ops per chunk; per-op overhead dominated the
    walk setup, device trace round 2).
    """
    i = jax.lax.broadcasted_iota(_i32, trusted.shape, 1)
    last_false = jax.lax.cummax(
        jnp.where(trusted, jnp.int32(-1), i), axis=1)
    runs = jnp.where(trusted, i - last_false, 0)    # [B, n]
    b = jnp.argmax(runs, axis=1).astype(_i32)       # first max == leftmost
    ln = jnp.take_along_axis(runs, b[:, None], 1)[:, 0]
    a = b - ln + 1
    return a, b, ln > 0


def _patch_lanes(hi, lo, bitpos, val):
    """Set the 2-bit field at global bit `bitpos` (0..2k-2) to `val`.

    hi holds bits 32..2k-1, lo bits 0..31 (k<17: everything in lo).
    Shapes broadcast; all uint32.
    """
    in_hi = bitpos >= 32
    sh = jnp.where(in_hi, bitpos - 32, bitpos).astype(_u32)
    m = ~(_u32(3) << sh)
    nhi = (hi & m) | (val << sh)
    nlo = (lo & m) | (val << sh)
    return jnp.where(in_hi, nhi, hi), jnp.where(in_hi, lo, nlo)


def _roll_rows_left(a: jax.Array, shift: jax.Array) -> jax.Array:
    """Per-row circular left roll by `shift` [B] (barrel shifter).

    log2(S) masked static rolls instead of a per-row gather.
    """
    S = a.shape[1]
    out = a
    b = 1
    while b < S:
        rolled = jnp.roll(out, -b, axis=1)
        out = jnp.where((shift & b)[:, None] != 0, rolled, out)
        b <<= 1
    return out


def _next_break(teff, valid, x, n):
    """First index i >= x with valid[i] & ~teff[i], else n.  [B] int32."""
    i = jax.lax.broadcasted_iota(_i32, teff.shape, 1)
    mask = valid & (~teff) & (i >= x[:, None])
    return jnp.min(jnp.where(mask, i, n), axis=1)


def _stack_walk_state(work, lanes, teff, err, j0, k, n, L):
    """Stack the mutable walk planes into one pre-rolled [5B, n+k]
    uint32 array (the _walk_loop layout below).  Shared by _walk_rounds
    (per-call) and infer_errors_scheduled (ONCE per batch: per-chunk
    stacking/rolling was ~half the walk wall time, device trace).

    The four byte-sized planes (effective trust, valid, err, working
    sequence) pack into BYTE FIELDS of a single u32 "misc" plane —
    byte 0 = teff, byte 1 = valid, byte 2 = err, byte 3 = work code —
    so the stack is 5 planes instead of 8: every barrel roll (the
    batch-level pre-roll was ~8.8 ms/batch, half the walk prologue;
    plus one roll per round) moves 37.5% fewer bytes at identical op
    count."""
    B = work.shape[0]
    fhi, flo, rhi, rlo, valid = lanes
    nk = valid.shape[1]                             # n + k

    def pad_nk(a):
        return jnp.concatenate(
            [a.astype(_u32), jnp.zeros((B, nk - a.shape[1]), _u32)], 1)

    misc = (pad_nk(teff) | (valid.astype(_u32) << 8)
            | (pad_nk(err) << 16) | (pad_nk(work[:, :L]) << 24))
    st0 = jnp.concatenate([fhi, flo, rhi, rlo, misc], 0)
    jc0 = jnp.minimum(j0, n - 1)
    return _roll_rows_left(st0, jnp.tile(jc0, 5))


def _walk_rounds(query_fn, work, lanes, teff, err, j0, k, n, L,
                 rev_ties, reduce_any=jnp.any, ext_cap=None,
                 skip_cols: int = 0):
    """All rounds of one directional walk on full-batch state.

    work: int8 [B, L+2k]; lanes: 4x uint32 [B, n+k] + valid bool [B, n+k];
    teff: bool [B, n] effective trust; err: bool [B, L]; j0: [B] cursor
    (n = done).  Returns (work, lanes, teff, err).

    The round body is per-op-overhead-bound at walk width, so ALL
    mutable state lives STACKED as one [5B, n+k] uint32 array — 4 lane
    word planes plus a packed "misc" plane carrying effective trust,
    valid, err, and the working sequence as byte fields (layout in
    _stack_walk_state) — kept PRE-ROLLED so each row's cursor window
    sits at column 0:

    skip_cols > 0 enables SPECULATIVE SKIP-RUNS: a break whose 3
    substitution candidates all fail their FIRST-window query has
    best_ext = 0 by definition (ext is a leading-true count), so its
    round is provably non-committing — it changes no lane, trust, or
    sequence state, only marks the error and advances the cursor by 1.
    Runs of consecutive such breaks are therefore exactly the untrusted
    valid windows after the cursor, and one round can mark and skip the
    whole run: each round additionally pre-screens the first-window
    candidates of the next `skip_cols` columns (3 probes/column — the
    first window of the break at column c is column c itself, patched at
    lane bit 0 fwd / 2(k-1) rc), then, on non-commit rows, jumps the
    cursor to the first pre-screen-PASSING break (everything before it
    is marked in one shot via a static (k-1)-column shift of the run
    mask — the error base of window c is base c+k-1).  A passing break
    commits in its own full round next (first window trusted == ext>=1).
    Output bits are identical; error-dense reads whose breaks rarely
    commit collapse from one round per break to one per skip_cols.

      - window take = a static [:, :k] slice (free),
      - put-back = a lane concatenate over the first k columns (free),
      - the per-base sequence/error updates land on static column k-1
        (absolute position jc+k-1) — no serialized row scatters,
      - ONE barrel roll per round, by the cursor advance delta.

    Every row's cumulative roll converges to n-1 when its cursor
    finishes (delta = min(j_next, n-1) - jc telescopes from the initial
    min(j0, n-1) roll), so the final un-roll is a single STATIC
    jnp.roll by n-1.  Device trace (round 2): the previous 3-roll-set
    form spent ~40 us/round outside the probe gather; this halves the
    non-gather round body.
    """
    st0 = _stack_walk_state(work, lanes, teff, err, j0, k, n, L)
    valid = lanes[4]
    B = work.shape[0]
    planes = _walk_loop(query_fn, j0, st0, k=k, n=n, L=L,
                        rev_ties=rev_ties, reduce_any=reduce_any,
                        ext_cap=ext_cap, skip_cols=skip_cols)
    # every row's cumulative roll is exactly n-1 at exit: static un-roll
    pl = jnp.roll(planes, n - 1, axis=1)
    misc = pl[4 * B:]
    teff_out = (misc[:, :n] & 0xFF) > 0
    err_out = ((misc[:, :L] >> 16) & 0xFF) > 0
    work_out = jnp.concatenate(
        [(misc[:, :L] >> 24).astype(jnp.int8),
         jnp.full((B, 2 * k), 4, dtype=jnp.int8)], 1)
    return work_out, (pl[:B], pl[B:2 * B], pl[2 * B:3 * B],
                      pl[3 * B:4 * B], valid), teff_out, err_out


def _walk_loop(query_fn, j0, st0, *, k, n, L, rev_ties,
               reduce_any=jnp.any, ext_cap=None, skip_cols: int = 0):
    """The rounds while-loop over pre-stacked, pre-rolled walk state
    (layout/documentation in _walk_rounds / _stack_walk_state); returns
    the final planes [5B, n+k], still rolled by n-1 per row."""
    from ..constants import DEFAULT_EXT_CAP
    W = min(ext_cap if ext_cap is not None else DEFAULT_EXT_CAP, k)
    # trial-extension cap (D7; --ext-cap k = reference semantics)
    B = st0.shape[0] // 5
    nk = st0.shape[1]                               # n + k
    t_vec = jax.lax.broadcasted_iota(_i32, (1, k), 1)
    tw_vec = t_vec[:, :W]
    bit_f = (2 * t_vec)[None]                       # [1, 1, k]
    bit_r = (2 * (k - 1 - t_vec))[None]
    c3_iota = jnp.arange(3, dtype=_i32)

    def cond(st):
        # reduce_any must be GLOBAL when query_fn contains collectives
        # (a device-local condition deadlocks the rendezvous when devices
        # disagree on the trip count)
        return reduce_any(st[0] < n)

    def body(st):
        j, planes = st
        active = j < n
        jc = jnp.minimum(j, n - 1)                  # clamp for done rows
        win5 = planes[:, :k]                        # static slice: free
        wf_hi, wf_lo = win5[:B], win5[B:2 * B]
        wr_hi, wr_lo = win5[2 * B:3 * B], win5[3 * B:4 * B]
        misc_win = win5[4 * B:]                     # packed byte fields
        old_te = (misc_win & 0xFF) > 0
        wvalid = ((misc_win >> 8) & 0xFF) > 0
        orig = ((planes[4 * B:, k - 1] >> 24)
                & 0xFF).astype(_i32)                # work col k-1 [B]

        # only the 3 NON-original candidates are built and queried, in
        # ascending original-code order (the oracle's `c == orig:
        # continue`).  Effective trust is EXACT — the commit-round
        # pre-fill below covers all k windows a commit can change — so
        # the break window is untrusted under the original base by
        # construction: the original plane's probes and the old
        # trusted_here re-verify path were provably dead (a quarter of
        # the round's serialized probe traffic).
        c3 = c3_iota[None, :] + \
            (c3_iota[None, :] >= orig[:, None]).astype(_i32)    # [B, 3]
        cval = c3.astype(_u32)[:, :, None]          # [B, 3, 1]
        pf_hi, pf_lo = _patch_lanes(wf_hi[:, None], wf_lo[:, None],
                                    bit_f, cval)
        pr_hi, pr_lo = _patch_lanes(wr_hi[:, None], wr_lo[:, None],
                                    bit_r, _u32(3) - cval)
        chi, clo = canonical_from_lanes(pf_hi, pf_lo, pr_hi, pr_lo)
        # only the first W windows are queried (ext caps at W, D7): the
        # probe gather dominates round cost, so probe traffic shrinks
        # k/W-fold; lanes are still patched for all k windows
        in_w = wvalid[:, None, :W] & \
            (tw_vec[None] < (n - jc)[:, None, None])        # [B, 3*, W]
        if STAGED_QUERY and W >= 2:
            # TOP-2 candidate probing (round-4 redesign).  ext is a
            # LEADING-true count, so a candidate failing its FIRST
            # window has ext 0 exactly — only ALIVE candidates need
            # their windows 1..W-1.  The round-3 staged design picked
            # between a 1-candidate and a 3-candidate extension with a
            # GLOBAL reduce_any(nalive >= 2) cond — but at walk width
            # 512 some lane almost always has 2 alive candidates
            # (filter-B FPR + genuine repeats), so the wide branch ran
            # every round and the staging was inert (measured: staged
            # == mono +-1%, docs/PERF.md round 4).  Here the choice is
            # PER ROW and unconditional: stage A probes window 0 of
            # all 3 candidates (3 probes/lane); stage B extends the
            # first (i1 = argmax) and last (i2 = reverse argmax) alive
            # candidates — 2(W-1) probes/lane; only the 3-alive case
            # (both wrong substitutions pass window 0: ~FPR^2 per row)
            # needs slot 1's extension, behind a rarely-true global
            # cond.  Composite q == the monolithic [B, 3, W] query
            # bit-for-bit: alive candidates are always one of
            # {i1, i2, slot 1 w/ 3 alive}; dead candidates have ext 0
            # from qA so their tail is never read.  reduce_any keeps
            # the cond rendezvous-safe when query_fn has collectives.
            qA = query_fn(chi[:, :, :1], clo[:, :, :1]) & in_w[:, :, :1]
            alive = qA[:, :, 0]                             # [B, 3]
            nalive = jnp.sum(alive.astype(_i32), axis=1)
            i1 = jnp.argmax(alive, axis=1).astype(_i32)     # first alive
            i2 = (2 - jnp.argmax(alive[:, ::-1], axis=1)).astype(_i32)

            def pick_c(stacked, ci):            # [B, 3, W-1] -> [B, W-1]
                out = stacked[:, 0]
                for c in range(1, 3):
                    out = jnp.where(ci[:, None] == c, stacked[:, c], out)
                return out

            q1 = query_fn(pick_c(chi[:, :, 1:W], i1),
                          pick_c(clo[:, :, 1:W], i1))       # [B, W-1]
            q2c = query_fn(pick_c(chi[:, :, 1:W], i2),
                           pick_c(clo[:, :, 1:W], i2))      # [B, W-1]

            def midq(_):
                # all-3-alive rows have i1 = 0, i2 = 2: slot 1 is the
                # uncovered one by construction
                return query_fn(chi[:, :, 1:W][:, 1],
                                clo[:, :, 1:W][:, 1])       # [B, W-1]

            def zeroq(_):
                return jnp.zeros((B, W - 1), bool)

            qm = jax.lax.cond(reduce_any(nalive >= 3), midq, zeroq, None)
            c3i = c3_iota[None, :, None]
            qB = (((c3i == i1[:, None, None]) & q1[:, None, :])
                  | ((c3i == i2[:, None, None]) & q2c[:, None, :])
                  | ((c3i == 1) & (nalive >= 3)[:, None, None]
                     & qm[:, None, :])) & in_w[:, :, 1:]
            q = jnp.concatenate([qA, qB], axis=2)           # [B, 3, W]
        else:
            q = query_fn(chi[:, :, :W], clo[:, :, :W]) & in_w
        ext = _leading_true(q)                              # [B, 3]

        # RC walk: ties -> largest RC code == smallest original code.
        # rev_ties is either a static bool (whole batch one direction)
        # or a per-row bool vector (direction-split scheduling mixes
        # forward and RC lanes in one chunk).
        if isinstance(rev_ties, bool):
            if rev_ties:
                bi = (2 - jnp.argmax(ext[:, ::-1], axis=1)).astype(_i32)
            else:
                bi = jnp.argmax(ext, axis=1).astype(_i32)
        else:
            bi_f = jnp.argmax(ext, axis=1).astype(_i32)
            bi_r = (2 - jnp.argmax(ext[:, ::-1], axis=1)).astype(_i32)
            bi = jnp.where(rev_ties, bi_r, bi_f)
        best_c = jnp.take_along_axis(c3, bi[:, None], 1)[:, 0]
        best_ext = jnp.take_along_axis(ext, bi[:, None], 1)[:, 0]

        mark = active
        commit = mark & (best_ext >= 1)

        # chosen candidate's patched lanes: 3-way select, not gather
        cm = commit[:, None]

        def pick(stacked):                          # [B, 3, k] -> [B, k]
            out = stacked[:, 0]
            for c in range(1, 3):
                out = jnp.where(bi[:, None] == c, stacked[:, c], out)
            return out

        nf_hi = jnp.where(cm, pick(pf_hi), wf_hi)
        nf_lo = jnp.where(cm, pick(pf_lo), wf_lo)
        nr_hi = jnp.where(cm, pick(pr_hi), wr_hi)
        nr_lo = jnp.where(cm, pick(pr_lo), wr_lo)

        # effective trust: COMMIT rows refresh all k windows a commit
        # can change — windows t < W carry the candidate query, the
        # remaining windows [W, k) of the CHOSEN sequence get their real
        # trust from a second query in the same round.  (Marking them
        # unknown->untrusted instead — the previous design — made the
        # cursor stop at each stale window for a "re-verify" round:
        # ~3 extra rounds per committed fix at W=8, k=32, and those
        # rounds were ~75% of all walk rounds.  The pre-fill is exactly
        # the value the oracle's later per-window trust check computes,
        # on the already-patched lanes, so output bits are unchanged.)
        # Non-commit rows change nothing, so their trust IS old_te.
        q_ch = pick(q)                                        # [B, W]
        in_n = t_vec < (n - jc)[:, None]            # window idx < n
        if W < k:
            chi_t = pick(chi)                                 # [B, k]
            clo_t = pick(clo)
            # q2's result only matters on commit rows; rounds with no
            # commit anywhere (most rounds in hard/junk chunks) skip
            # the serialized [B, k-W] gather entirely.  The predicate
            # uses the caller's reduce_any so that a collective
            # query_fn stays rendezvous-safe: all devices agree on
            # whether the branch (and its collectives) runs.
            q2 = jax.lax.cond(
                reduce_any(commit),
                lambda a: query_fn(a[0], a[1]),
                lambda a: jnp.zeros((B, k - W), bool),
                (chi_t[:, W:], clo_t[:, W:]))
            q2 = q2 & wvalid[:, W:] & in_n[:, W:]
            q_all = jnp.concatenate([q_ch, q2], 1)            # [B, k]
        else:
            q_all = q_ch
        te_new = jnp.where(commit[:, None] & in_n, q_all, old_te)

        # misc put-back on the k window columns: byte 0 <- te_new; the
        # sequence + error updates land on col k-1 (absolute jc+k-1),
        # INSIDE the window — byte 2 |= mark, byte 3 <- newb
        newb = jnp.where(commit, best_c, orig)
        colk = t_vec == (k - 1)                     # [1, k]
        misc_k = (misc_win & _u32(0xFFFFFF00)) | te_new.astype(_u32)
        misc_k = misc_k | jnp.where(colk & mark[:, None],
                                    _u32(1) << 16, _u32(0))
        misc_k = jnp.where(
            colk & active[:, None],
            (misc_k & _u32(0x00FFFFFF)) | (newb.astype(_u32)[:, None]
                                           << 24),
            misc_k)
        misc_full = jnp.concatenate([misc_k, planes[4 * B:, k:]], 1)

        # put-back: splice the k window columns (pure lane concatenate)
        vals4 = jnp.concatenate([nf_hi, nf_lo, nr_hi, nr_lo], 0)
        upd4 = jnp.concatenate([vals4, planes[:4 * B, k:]], 1)

        # next break in ROLLED coordinates: first col c >= adv with
        # valid & ~teff and c < n - jc (absolute < n), else done
        adv = jnp.maximum(best_ext, 1)      # committed ext, else 1
        c_iota = jax.lax.broadcasted_iota(_i32, (B, nk), 1)
        brk = (((misc_full >> 8) & 0xFF) > 0) & ((misc_full & 0xFF) == 0) \
            & (c_iota >= adv[:, None]) & (c_iota < (n - jc)[:, None])
        rel = jnp.min(jnp.where(brk, c_iota, nk), axis=1)

        if skip_cols:
            # speculative skip-run (docstring): pre-screen the 3
            # first-window candidates of the next C columns.  On
            # NON-commit rows brk is the old-trust break mask (te_new ==
            # old_te there) and adv == 1, i.e. exactly the breaks the
            # sequential walk would visit with unchanged state — mark
            # every pre-screen-failing break up to the first passing
            # one and jump the cursor there.  Commit rows keep `rel`.
            C = min(skip_cols, nk - k + 1)
            s_fhi, s_flo = planes[:B, :C], planes[B:2 * B, :C]
            s_rhi, s_rlo = planes[2 * B:3 * B, :C], planes[3 * B:4 * B, :C]
            origs = ((planes[4 * B:, k - 1:k - 1 + C] >> 24)
                     & 0xFF).astype(_i32)
            cs3 = c3_iota[None, None, :] + \
                (c3_iota[None, None, :] >= origs[:, :, None]).astype(_i32)
            cv = cs3.astype(_u32)
            p_fhi, p_flo = _patch_lanes(s_fhi[:, :, None],
                                        s_flo[:, :, None],
                                        jnp.int32(0), cv)
            p_rhi, p_rlo = _patch_lanes(s_rhi[:, :, None],
                                        s_rlo[:, :, None],
                                        jnp.int32(2 * (k - 1)),
                                        _u32(3) - cv)
            shi, slo = canonical_from_lanes(p_fhi, p_flo, p_rhi, p_rlo)
            may_commit = jnp.any(query_fn(shi, slo), axis=-1)   # [B, C]
            # columns beyond the pre-screen window always stop the run
            stop = jnp.concatenate(
                [may_commit, jnp.ones((B, nk - C), bool)], 1)
            rel_run = jnp.min(jnp.where(brk & stop, c_iota, nk), axis=1)
            run_on = active & ~commit
            runm = brk & (c_iota < rel_run[:, None]) & run_on[:, None]
            rel = jnp.where(run_on, rel_run, rel)
            # marks: window col c's error base is col c+k-1 (static shift)
            misc_full = misc_full | (jnp.concatenate(
                [jnp.zeros((B, k - 1), _u32),
                 runm[:, :nk - k + 1].astype(_u32)], 1) << 16)
        j_next = jnp.where(active, jnp.minimum(jc + rel, n), n)

        delta = jnp.minimum(j_next, n - 1) - jc
        planes = jnp.concatenate([upd4, misc_full], 0)
        planes = _roll_rows_left(planes, jnp.tile(delta, 5))
        return (j_next, planes)

    _, planes = jax.lax.while_loop(cond, body, (j0, st0))
    return planes


def infer_errors_core(query_fn, codes: jax.Array, k: int,
                      reduce_any=jnp.any, ext_cap=None,
                      trusted0=None, lanes=None) -> jax.Array:
    """Error mask per base for a batch (D7), generic over the trusted-
    filter query: query_fn(hi, lo) -> bool hits.  Used directly by the
    hash-space-sharded pipeline (whose query is a collective; it must
    also pass a globally-reduced `reduce_any` so every device runs the
    same number of rounds); single-chip callers use infer_errors_batch.

    trusted0: optional precomputed `query_fn(hi, lo) & valid` for this
    batch (callers that already queried all windows — e.g. for
    difficulty scheduling — pass it to skip the redundant re-query).
    lanes: optional precomputed kmer_lanes_batch(codes, k) tuple —
    scheduled callers compute lanes once at batch level and slice, so
    the per-chunk walk bodies skip the packing entirely.
    """
    B, L = codes.shape
    n = L - k + 1

    fhi, flo, rhi, rlo, valid = (kmer_lanes_batch(codes, k)
                                 if lanes is None else lanes)
    if trusted0 is None:
        hi, lo = canonical_from_lanes(fhi, flo, rhi, rlo)
        trusted0 = query_fn(hi, lo) & valid

    any_valid = valid.any(axis=1)
    all_tr = jnp.all(trusted0 | ~valid, axis=1)
    a, b, has_anchor = _longest_run_anchors(trusted0)
    active = any_valid & ~all_tr & has_anchor

    zpad = jnp.zeros((B, k), dtype=_u32)
    vpad = jnp.zeros((B, k), dtype=bool)
    lanes = (jnp.concatenate([fhi, zpad], 1), jnp.concatenate([flo, zpad], 1),
             jnp.concatenate([rhi, zpad], 1), jnp.concatenate([rlo, zpad], 1),
             jnp.concatenate([valid, vpad], 1))
    work = jnp.concatenate(
        [codes, jnp.full((B, 2 * k), 4, dtype=jnp.int8)], 1)
    err = jnp.zeros((B, L), dtype=bool)
    teff = trusted0

    def walk_fn(w, la, te, e, j, rt):
        return _walk_rounds(query_fn, w, la, te, e, j, k, n, L,
                            rev_ties=rt, reduce_any=reduce_any,
                            ext_cap=ext_cap)

    # rightward walk from anchor end
    x0 = jnp.where(active, b + 1, n)
    j0 = _next_break(teff, valid, x0, n)
    work, lanes, teff, err = walk_fn(work, lanes, teff, err, j0, False)

    # leftward walk == rightward walk on the reverse complement; RC lane
    # state is the flipped (rc, fwd) pair, RC trust is flipped trust —
    # right-walk commits carry over for free
    fhi, flo, rhi, rlo, vv = lanes
    flip = lambda x: x[:, :n][:, ::-1]
    rc_lanes = (jnp.concatenate([flip(rhi), fhi[:, n:]], 1),
                jnp.concatenate([flip(rlo), flo[:, n:]], 1),
                jnp.concatenate([flip(fhi), rhi[:, n:]], 1),
                jnp.concatenate([flip(flo), rlo[:, n:]], 1),
                jnp.concatenate([flip(vv), vpad], 1))
    rc_work = jnp.concatenate(
        [_complement(work[:, :L])[:, ::-1],
         jnp.full((B, 2 * k), 4, dtype=jnp.int8)], 1)
    rc_teff = teff[:, ::-1]
    rc_err = jnp.zeros((B, L), dtype=bool)
    x0_rc = jnp.where(active, n - a, n)
    j0_rc = _next_break(rc_teff, flip(vv), x0_rc, n)
    _, _, _, rc_err = walk_fn(rc_work, rc_lanes, rc_teff, rc_err,
                              j0_rc, True)
    return err | rc_err[:, ::-1]


@functools.partial(jax.jit, static_argnames=("k", "num_hashes", "ext_cap"))
def infer_errors_batch(rows: jax.Array, codes: jax.Array, k: int,
                       num_hashes: int, ext_cap=None,
                       trusted0=None, lanes=None) -> jax.Array:
    """infer_errors_core against a local packed filter (uint32 [m/32]
    from ops.bloom.bloom_rows)."""
    qf = lambda hi, lo: bloom_query_rows(rows, hi, lo, num_hashes)
    return infer_errors_core(qf, codes, k, ext_cap=ext_cap,
                             trusted0=trusted0, lanes=lanes)


def _permute_rows_mxu(onehot_bf16: jax.Array, x: jax.Array) -> jax.Array:
    """Row permutation as a one-hot matmul: out[i] = x[order[i]] when
    onehot[i, order[i]] = 1.

    A [B, B] x [B, C] matrix product standing in for the row gather
    x[order] (on the GPU `jnp.take(x, order, axis=0)` is the natural
    form; which one to keep is for the benchmark).  Exact for the
    small-integer/bool payloads here: each output element is a single
    bf16 product accumulated in f32.
    """
    y = jax.lax.dot(onehot_bf16, x.astype(jnp.bfloat16),
                    preferred_element_type=jnp.float32)
    return y.astype(x.dtype)


# default walk width: wider chunks amortize the per-chunk fixed cost,
# narrower ones cut the rounds a chunk's worst lane forces on the rest.
# Not yet tuned on the H100 (ROADMAP Design #4).  Must divide the batch
# size (8192).
WALK_CHUNK = 512

# speculative skip-run pre-screen width (columns ahead of the cursor
# whose candidate first-windows are queried each round): 3*C extra
# probes/lane/round vs up-to-C breaks skipped per round.  C=16 comes
# from an eager round-count grid on bench-like data; its round cost is
# not yet measured on the H100 (ROADMAP Design #4).  KBBQ_SKIP_COLS /
# KBBQ_SKIP_HARD_T env overrides exist for on-chip sweeps (both are
# static compile-time constants).
import os as _os

SKIP_COLS = int(_os.environ.get("KBBQ_SKIP_COLS", "16"))
# hard-tail routing threshold: lanes with more than this many initially-
# untrusted windows after the cursor run the skip-run engine; -1 means
# derive min(3k, n-1) at call time, 0 routes EVERY active chunk there.
# Default 0: the round-count census (20k bench-like reads) showed the
# worst lanes sit at difficulty keys 65-96 — BELOW the 3k=96 heuristic —
# and an instrumented eager run of this exact code counts 353 -> 48
# rounds with skip-all at identical output bits.
SKIP_HARD_T = int(_os.environ.get("KBBQ_SKIP_HARD_T", "0"))

# top-2 candidate probing (see the _walk_loop round body): stage A
# probes each candidate's FIRST window only, stage B unconditionally
# extends the top-2 alive candidates per row (+ a rare global cond for
# the 3-alive case).  Cuts the round's dominant probe gather from
# 3W to 3+2(W-1) probes/lane at identical output bits.  KBBQ_STAGED=0
# restores the monolithic [B, 3, W] query for sweeps.
STAGED_QUERY = _os.environ.get("KBBQ_STAGED", "1") == "1"


def infer_errors_chunked(rows, codes, k: int, num_hashes: int,
                         chunk: int = WALK_CHUNK, ext_cap=None) -> jax.Array:
    """infer_errors_batch in chunk-wide slices (async, no host sync)."""
    B, _ = codes.shape
    if B <= chunk:
        return infer_errors_batch(rows, codes, k, num_hashes, ext_cap)
    outs = [infer_errors_batch(rows, codes[s:s + chunk], k, num_hashes,
                               ext_cap)
            for s in range(0, B, chunk)]
    return jnp.concatenate(outs, axis=0)


def infer_errors(rows, codes, k: int, num_hashes: int,
                 walk_chunk: int | None = None, ext_cap=None,
                 trusted0=None, valid0=None) -> jax.Array:
    """THE production pass-3 entry point: difficulty-scheduled
    direction-split walks when the batch divides into walk chunks,
    plain whole-batch walks otherwise.  All pipelines (batched,
    resident, sharded, streaming) route here so walk-engine
    improvements land everywhere at once (round-2 VERDICT weak #8:
    two engines had drifted).  Output bits are identical either way
    (tests assert it).

    trusted0/valid0: optional precomputed initial all-window trust +
    validity (callers holding the pass-1 hash cache query filter B via
    the cached word test and skip the re-hash here)."""
    B = codes.shape[0]
    wc = walk_chunk or WALK_CHUNK
    if B <= wc or B % wc:
        return infer_errors_batch(rows, codes, k, num_hashes, ext_cap,
                                  trusted0=trusted0)
    return infer_errors_scheduled(rows, codes, k, num_hashes, chunk=wc,
                                  ext_cap=ext_cap, trusted0=trusted0,
                                  valid0=valid0)


@functools.partial(jax.jit, static_argnames=("k", "num_hashes", "chunk",
                                             "ext_cap"))
def infer_errors_scheduled(rows, codes, k: int, num_hashes: int,
                           chunk: int = WALK_CHUNK, ext_cap=None,
                           trusted0=None, valid0=None) -> jax.Array:
    """Difficulty-scheduled inference over DIRECTIONAL walk lanes.

    The right and left walks of one read are provably independent: the
    right walk only touches windows > anchor-end b (bases >= b+k) and
    the left walk only windows < anchor-start a (bases <= a+k-2), with
    a <= b — disjoint window, base, AND effective-trust ranges.  So
    each read contributes TWO independent lanes (forward walk on the
    read, left walk as a forward walk on its reverse complement), and
    the 2B lanes are difficulty-sorted TOGETHER:

      - a read whose breaks are all on one side leaves the other lane
        inactive (sorted to the front, never walked),
      - the worst lane's round count is the per-DIRECTION break count,
        not the whole-read count — the while-loop tail shrinks ~2x on
        junk-heavy chunks,
      - scheduling granularity doubles for free.

    The chunk loop runs as a dynamic-bound fori (walk body compiled
    once; all-inactive chunks never execute — key 0 sorts them first).
    Permutations run as one-hot matmuls (_permute_rows_mxu); lanes pack
    ONCE on the sorted work rows; the initial all-window query is every
    lane's effective trust — no re-query.  Requires B % chunk == 0 and
    2B % chunk == 0 (the resident pipeline pads batches).  Bit-identical
    to infer_errors_batch (tests).
    """
    B, L = codes.shape
    if B <= chunk:
        return infer_errors_batch(rows, codes, k, num_hashes, ext_cap,
                                  trusted0=trusted0)
    assert B % chunk == 0
    if trusted0 is None:
        hi, lo, valid = canonical_kmers_batch(codes, k)
        tr = bloom_query_rows(rows, hi, lo, num_hashes) & valid
    else:
        tr, valid = trusted0, valid0
    n = tr.shape[1]

    B2 = 2 * B
    assert B2 % chunk == 0
    a, b, has_anchor = _longest_run_anchors(tr)
    active = valid.any(1) & ~jnp.all(tr | ~valid, 1) & has_anchor

    rc_codes = _complement(codes)[:, ::-1]
    tr_rc = tr[:, ::-1]
    valid_rc = valid[:, ::-1]
    j0_f = _next_break(tr, valid, jnp.where(active, b + 1, n), n)
    j0_r = _next_break(tr_rc, valid_rc, jnp.where(active, n - a, n), n)

    work2 = jnp.concatenate([codes, rc_codes], 0)           # [2B, L]
    teff2 = jnp.concatenate([tr, tr_rc], 0)
    valid2 = jnp.concatenate([valid, valid_rc], 0)
    j02 = jnp.concatenate([j0_f, j0_r], 0)
    rev2 = jnp.concatenate([jnp.zeros(B, bool), jnp.ones(B, bool)], 0)

    iota_n = jax.lax.broadcasted_iota(_i32, (B2, n), 1)
    nb2 = jnp.sum(valid2 & ~teff2 & (iota_n >= j02[:, None]), 1)
    lane_on = j02 < n
    key = jnp.where(lane_on, nb2 + 1, 0)
    order = jnp.argsort(key)
    col = jax.lax.broadcasted_iota(jnp.int32, (B2, B2), 1)
    onehot = (col == order[:, None]).astype(jnp.bfloat16)
    sw = _permute_rows_mxu(onehot, work2)       # int8 codes: bf16-exact
    st2 = _permute_rows_mxu(onehot, teff2)
    sj = jnp.take(j02, order)                   # [2B] tiny gather
    srev = jnp.take(rev2, order)
    lanes_s = kmer_lanes_batch(sw, k)           # one pack, all chunks
    nc = B2 // chunk
    i0 = (B2 - jnp.sum(lane_on.astype(jnp.int32))) // chunk

    # ALL walk state stacks and pre-rolls ONCE at batch level ([5, 2B,
    # n+k]; te/valid/err/work live as byte fields of the misc plane —
    # see _stack_walk_state); each chunk takes one dynamic_slice, runs
    # only the rounds while-loop, and writes back only its (still-
    # rolled) misc plane — the per-chunk concats/rolls/unrolls were
    # ~half the walk wall time (device trace, round 2).  One static
    # batch-level roll restores error positions at the end (per-row
    # cumulative roll is exactly n-1 when a lane finishes, see
    # _walk_rounds).
    nk = n + k
    zpadB = jnp.zeros((B2, k), dtype=_u32)
    fhi_s, flo_s, rhi_s, rlo_s, vv_s = lanes_s
    lanes_p = (jnp.concatenate([fhi_s, zpadB], 1),
               jnp.concatenate([flo_s, zpadB], 1),
               jnp.concatenate([rhi_s, zpadB], 1),
               jnp.concatenate([rlo_s, zpadB], 1),
               jnp.concatenate([vv_s, zpadB.astype(bool)], 1))
    st3 = _stack_walk_state(sw, lanes_p, st2,
                            jnp.zeros((B2, L), bool), sj, k, n,
                            L).reshape(5, B2, nk)

    def chunk_body(i, misc_acc, skip_cols=0):
        s = i * chunk
        stc = jax.lax.dynamic_slice(
            st3, (0, s, 0), (5, chunk, nk)).reshape(5 * chunk, nk)
        qf = lambda chi, clo: bloom_query_rows(rows, chi, clo,
                                               num_hashes)
        planes = _walk_loop(
            qf, jax.lax.dynamic_slice_in_dim(sj, s, chunk, 0), stc,
            k=k, n=n, L=L,
            rev_ties=jax.lax.dynamic_slice_in_dim(srev, s, chunk, 0),
            ext_cap=ext_cap, skip_cols=skip_cols)
        return jax.lax.dynamic_update_slice_in_dim(
            misc_acc, planes[4 * chunk:], s, 0)

    # hard-tail split: lanes whose remaining untrusted-window count is
    # near-saturated (>= ~3k windows, i.e. >= ~3 error events in one
    # direction) are the error-dense reads whose breaks rarely commit —
    # their chunks run the speculative skip-run engine (one round per
    # run of non-committing breaks instead of one per break), everything
    # below the threshold keeps the plain engine and pays nothing.
    # Chunks are sorted ascending by key, so the tail starts at the
    # first chunk not entirely below the threshold.
    hard_T = (min(3 * k, max(n - 1, 1)) if SKIP_HARD_T < 0
              else SKIP_HARD_T)
    n_easy = jnp.sum((key <= hard_T).astype(jnp.int32))
    i1 = jnp.clip(n_easy // chunk, i0, nc)
    misc_rolled = jax.lax.fori_loop(
        i0, i1, chunk_body, jnp.zeros((B2, nk), _u32))
    misc_rolled = jax.lax.fori_loop(
        i1, nc, functools.partial(chunk_body, skip_cols=SKIP_COLS),
        misc_rolled)
    err_sorted = ((jnp.roll(misc_rolled, n - 1, axis=1)[:, :L] >> 16)
                  & 0xFF) > 0
    # inverse permutation, then fold the RC half back (errors are
    # per-BASE: RC lane position p is original position L-1-p)
    err2 = _permute_rows_mxu(onehot.T, err_sorted)
    return err2[:B] | err2[B:, ::-1]
