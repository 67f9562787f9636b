"""Hybrid dense-head / sparse-tail matrix layout — the optimized engine
behind the SpMM primitives.

Motivation: the plain COO gather/scatter SpMM moves one gathered row and
one scattered row per nonzero, while a dense matmul over the same entries
streams each operand once at matrix-unit rates. Text corpora are
Zipf-distributed, so a small set of head words carries most of the
nonzeros. We therefore split

    B = B_head + B_tail

  - B_head: the top-R rows (words) stored DENSE as an (R x docs) float32
    matrix. Both SpMM directions on the head are single dense matmuls.
  - B_tail: the remaining entries in dual-sorted COO, with each segment
    (doc for the doc-sorted copy, word for the word-sorted copy) padded to
    a multiple of 8 rows. Because segments then align to 8-row groups, the
    gathered (n x width) block reduces 8-to-1 with a pure reshape-sum
    before the scatter-add, cutting scatter traffic 8x (the two-level
    sorted segment sum).

This mirrors the reference's cache-conscious splits (nnz-balanced row
blocks, include/matUtils.h:244-268) re-derived for an accelerator's
matrix units and memory bandwidth. Whether the split pays on a given
device is measured, not assumed (see ROADMAP.md, design debt D6).
The layout is built ON DEVICE from a DocSparse (one top-k + a few
segment-sums + scatters), so no large host round-trips occur.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .sparse import DocSparse

HI = jax.lax.Precision.HIGHEST
DEFAULT_CHUNK = 1 << 21

# Head scatters use FLAT 1D indices (r * ncols + c): XLA's 2D scatter
# materializes an (nnz, 2) index operand that, at some shapes, is assigned
# a tiled layout padding the minor dim 2 -> 128 (24.7 GB at 48M entries —
# a compile-time out-of-memory). The flat form keeps the
# index operand 1D. Requires (rows+1)*(cols+1) < 2^31; callers clamp the
# head size with `max_head_rows`.
_INT32_FLAT_CAP = (1 << 31) - (1 << 20)


def row_scale_from_zetas(zetas) -> jax.Array:
    """sqrt(zeta) per word with the drop sentinel neutralized. The
    few_samples/bad_threshold drop flags (hyperparams.h:14-25) mark
    dropped words with zeta=+inf (thresholds.py); such words keep ZERO
    entries, so their factored row scale never multiplies a real value —
    but sqrt(inf)=inf poisons the dense-head products when a dropped
    word is top_k-selected into the head (Xs = X * row_scale has an inf
    row; the bf16 binary head row is all-zero, and 0 * inf = NaN in the
    head dot). Neutralize to 0: a zero-nnz row contributes exactly 0."""
    z = jnp.asarray(zetas, jnp.float32)
    return jnp.sqrt(jnp.where(jnp.isfinite(z), z, 0.0))


def max_head_rows(num_docs: int) -> int:
    """Largest head row count whose flat scatter index stays in int32.

    Can be < 8 (even 0) for num_docs beyond ~238M — callers must skip the
    hybrid layout then (the old floor of 8 would silently wrap the int32
    flat index rr*(num_docs+1)+dd and corrupt the head build). The
    `break_head_cap` knob (DeviceConfig) lifts this limit via the
    doc-blocked scatter in _scatter_head."""
    return max(_INT32_FLAT_CAP // (num_docs + 1) - 1, 0)


def _scatter_head(rr, dd, vals, num_head: int, ncols: int, flat_cap: int):
    """Scatter nnz-length (rr, dd) pairs into a dense (num_head, ncols)
    head. Sentinels rr == num_head / dd == ncols land in the sliced-off
    guard row/column. vals=None builds the bf16 binary occupancy head
    (factored mode, .set(1)); otherwise a float32 .add(vals) head.

    When (num_head+1)*(ncols+1) exceeds `flat_cap` (the int32 flat-index
    budget), the scatter is split into COLUMN BLOCKS: each block re-masks
    the full entry stream to its doc range, scatters with a local flat
    index rr*(block+1)+local_dd into a (num_head+1, block+1) slab, and
    dynamic_update_slice's the slab into the head. Ops over the head are unchanged — the cost is one extra
    nnz-length masked scatter per extra block at build time."""
    if (num_head + 1) * (ncols + 1) <= flat_cap:
        flat = rr * jnp.int32(ncols + 1) + dd
        if vals is None:
            H = jnp.zeros(((num_head + 1) * (ncols + 1),), jnp.bfloat16)
            H = H.at[flat].set(jnp.bfloat16(1.0))
        else:
            H = jnp.zeros(((num_head + 1) * (ncols + 1),), jnp.float32)
            H = H.at[flat].add(vals)
        return H.reshape(num_head + 1, ncols + 1)[:num_head, :ncols]

    maxblock = flat_cap // (num_head + 1) - 1
    if maxblock < 8:
        raise ValueError(
            f"num_head={num_head} leaves a column block < 8 under "
            f"flat_cap={flat_cap}; shrink the head budget"
        )
    nblocks = -(-ncols // maxblock)
    # Even the blocks out instead of using maxblock-sized ones: with
    # maxblock the head is allocated nblocks*maxblock wide — up to ~1.5x
    # the real head (12 GB vs 8.6 GB at R=14,316, D=300k: compile OOM).
    # ceil(ncols/nblocks) <= maxblock keeps the flat index in budget and
    # the overshoot below nblocks columns.
    block = -(-ncols // nblocks)
    dtype = jnp.bfloat16 if vals is None else jnp.float32

    # fori_loop, NOT a static unroll: with unrolled dynamic_update_slice
    # chains XLA materializes a padded full-width temp per update (~1.4x
    # the head — 12 GB at R=14,316, D=300k: a compile-time out-of-memory
    # on a 16 GB device). As a loop carry the head buffer is input/output
    # -aliased and each slice update runs in place, so the peak is
    # head + ONE block slab.
    def body(b, H):
        lo = b * jnp.int32(block)
        local = dd - lo
        inb = (local >= 0) & (local < block) & (rr < num_head)
        rr_b = jnp.where(inb, rr, num_head)
        dd_b = jnp.where(inb, local, block)
        flat = rr_b * jnp.int32(block + 1) + dd_b
        S = jnp.zeros(((num_head + 1) * (block + 1),), dtype)
        if vals is None:
            S = S.at[flat].set(jnp.bfloat16(1.0))
        else:
            S = S.at[flat].add(vals)
        S = S.reshape(num_head + 1, block + 1)[:num_head, :block]
        return jax.lax.dynamic_update_slice(H, S, (jnp.int32(0), lo))

    H = jax.lax.fori_loop(
        0, nblocks, body, jnp.zeros((num_head, nblocks * block), dtype)
    )
    return H[:, :ncols]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HybridSparse:
    """Dense head (R x D) + octet-padded dual-sorted COO tail.

    Two storage modes:

    - general (`row_scale is None`): head holds the actual float values,
      the tail carries per-entry vals (td_val/tw_val).
    - factored (`row_scale` set): every nonzero of row w equals
      row_scale[w] — true for the thresholded matrix B, whose entries are
      all sqrt(zeta_w) (reference src/sparseMatrix.cpp:1349). Then the
      head stores only the BINARY occupancy pattern in bfloat16 (0/1 are
      exact in bf16, so this is lossless and HALVES the head's HBM
      footprint/streaming, letting the head absorb twice the Zipf mass),
      and the tail stores no values at all: bt_x gathers from the
      row-pre-scaled operand Xs = X * row_scale[:, None], and b_y scales
      its output rows once — bitwise the same per-entry products as the
      general mode.
    """

    head_words: jax.Array  # (R,) int32 word ids of dense rows
    head: jax.Array  # (R, D) float32 values, or bfloat16 binary (factored)
    # tail, doc-sorted, segments padded to x8; pads: word=vocab, val=0
    td_word: jax.Array  # (Nt,)
    td_val: Optional[jax.Array]  # (Nt,) — None in factored mode
    td_odoc: jax.Array  # (Nt/8,) per-octet doc id (num_docs for all-pad)
    # tail, word-sorted, segments padded to x8; pads: doc=num_docs, val=0
    tw_doc: jax.Array  # (Nw,)
    tw_val: Optional[jax.Array]  # (Nw,) — None in factored mode
    tw_oword: jax.Array  # (Nw/8,) per-octet word id (vocab for all-pad)
    row_scale: Optional[jax.Array]  # (vocab,) float32, factored mode only
    vocab: int = dataclasses.field(metadata=dict(static=True))
    num_docs: int = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    head_nnz: int = dataclasses.field(metadata=dict(static=True))

    @property
    def num_head(self) -> int:
        return self.head_words.shape[0]


def _pad8_plan(mask: jax.Array, seg: jax.Array, num_segments: int):
    """Positions for compaction of masked entries into per-segment blocks
    padded to multiples of 8. Returns (pos, padded_counts, offsets).

    REQUIRES seg non-decreasing (every caller holds a sorted copy; spill
    entries carry seg == num_segments and mask == False). Sortedness lets
    per-segment counts come from the kept-prefix sums sampled at segment
    boundaries (one binary search) instead of a 48M-scalar segment_sum
    scatter (~0.45 s each at the NYTimes shape), and the position needs
    one fused gather: pos = grank + (offsets - kept_before)[seg]."""
    m = mask.astype(jnp.int32)
    incl = jnp.cumsum(m)
    G = jnp.concatenate([jnp.zeros((1,), jnp.int32), incl])  # kept in [0,i)
    bounds = jnp.searchsorted(
        seg, jnp.arange(num_segments + 1, dtype=seg.dtype), side="left"
    )
    kept_before = G[bounds]  # (S+1,) kept entries in segments < s
    counts = kept_before[1:] - kept_before[:-1]
    padded = ((counts + 7) // 8) * 8
    offsets = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(padded)]
    )
    dstart = offsets - kept_before  # (S+1,)
    segc = jnp.minimum(seg, num_segments)
    pos = jnp.where(mask, (incl - 1) + dstart[segc], jnp.int32(0x7FFFFFF0))
    return pos, padded, offsets


@partial(jax.jit, static_argnames=("num_head",))
def _head_select(sp: DocSparse, num_head: int):
    V = sp.vocab
    counts = jax.ops.segment_sum(
        (sp.w_word < V).astype(jnp.int32), sp.w_word, num_segments=V + 1,
        indices_are_sorted=True,
    )[:V]
    _, head_words = jax.lax.top_k(counts, num_head)
    head_words = jnp.sort(head_words).astype(jnp.int32)
    is_head = jnp.zeros((V + 1,), bool).at[head_words].set(True)
    rank = jnp.zeros((V + 1,), jnp.int32).at[head_words].set(
        jnp.arange(num_head, dtype=jnp.int32)
    )
    return head_words, is_head, rank


@partial(jax.jit, static_argnames=("num_head", "num_docs", "flat_cap"))
def _build_head(sp: DocSparse, rank, is_head, num_head: int, num_docs: int,
                flat_cap: int = _INT32_FLAT_CAP):
    r = rank[sp.d_word]
    hmask = is_head[sp.d_word]
    rr = jnp.where(hmask, r, num_head)
    dd = jnp.where(hmask, sp.d_doc, num_docs)
    H = _scatter_head(rr, dd, sp.d_val, num_head, num_docs, flat_cap)
    return H, hmask.sum()


@partial(jax.jit, static_argnames=("num_head", "num_docs", "flat_cap"))
def _build_head_binary(sp: DocSparse, rank, is_head, num_head: int,
                       num_docs: int, flat_cap: int = _INT32_FLAT_CAP):
    """Factored mode: bfloat16 occupancy pattern (0/1 exact in bf16),
    built directly in bf16 so no f32-sized temporary ever exists."""
    r = rank[sp.d_word]
    hmask = is_head[sp.d_word]
    rr = jnp.where(hmask, r, num_head)
    dd = jnp.where(hmask, sp.d_doc, num_docs)
    H = _scatter_head(rr, dd, None, num_head, num_docs, flat_cap)
    return H, hmask.sum()


@partial(jax.jit, static_argnames=("vocab", "num_segments"))
def _tail_plan(word, seg, is_head, vocab: int, num_segments: int):
    mask = (~is_head[word]) & (word < vocab)
    return _pad8_plan(mask, seg, num_segments)


def _oseg_from_offsets(offsets: jax.Array, n_pad: int) -> jax.Array:
    """Per-octet segment ids derived directly from the padded block
    offsets (cumsum of x8-padded per-segment counts, length S+1): octet j
    covers positions [8j, 8j+8), blocks are x8-aligned so octets never
    straddle a segment, hence octet j belongs to the unique s with
    offsets[s] <= 8j < offsets[s+1]; octets at/after the total get the
    spill id S. Replaces a full-size scatter + octet min-reduce with a
    vectorized binary search."""
    starts = jnp.arange(n_pad // 8, dtype=jnp.int32) * 8
    return (
        jnp.searchsorted(offsets, starts, side="right") - 1
    ).astype(jnp.int32)


@partial(jax.jit, static_argnames=("vocab", "n_pad"))
def _compact_tail(word, val, pos, offsets, vocab: int, n_pad: int):
    out_w = jnp.full((n_pad,), vocab, jnp.int32).at[pos].set(word, mode="drop")
    out_v = jnp.zeros((n_pad,), jnp.float32).at[pos].set(val, mode="drop")
    return out_w, out_v, _oseg_from_offsets(offsets, n_pad)


@partial(jax.jit, static_argnames=("n_pad", "fill"))
def _compact_ids(ids, pos, n_pad: int, fill: int):
    return jnp.full((n_pad,), fill, jnp.int32).at[pos].set(ids, mode="drop")


@partial(jax.jit, static_argnames=("n_pad", "fill"))
def _compact_tail_novals(ids, pos, offsets, n_pad: int, fill: int):
    """Factored-mode compaction: per-entry ids + per-octet segment ids,
    no value array."""
    out_i = jnp.full((n_pad,), fill, jnp.int32).at[pos].set(ids, mode="drop")
    return out_i, _oseg_from_offsets(offsets, n_pad)


@partial(jax.jit, static_argnames=("n_pad", "fill"))
def _compact_tail_remap(ids, remap, pos, offsets, n_pad: int, fill: int):
    """_compact_tail_novals with the id remapping (remap[ids]) fused into
    the same program instead of a separate eager 48M gather pass."""
    out_i = jnp.full((n_pad,), fill, jnp.int32).at[pos].set(
        remap[ids], mode="drop"
    )
    return out_i, _oseg_from_offsets(offsets, n_pad)


@partial(jax.jit, static_argnames=("n_pad", "fill"))
def _compact_tail_oseg_remap(ids, pos, offsets, oseg_remap, n_pad: int,
                             fill: int):
    """_compact_tail_novals whose per-octet segment ids pass through
    oseg_remap — lets the doc-side plan run on RAW doc ids (the doc
    renumbering is monotone and dropped docs are empty segments, so the
    padded positions are identical) and remap only the 8x-smaller octet
    ids, instead of an eager 48M remap gather before the plan."""
    out_i = jnp.full((n_pad,), fill, jnp.int32).at[pos].set(ids, mode="drop")
    return out_i, oseg_remap[_oseg_from_offsets(offsets, n_pad)]


def to_hybrid(
    sp: DocSparse,
    num_head: int,
    chunk: int = DEFAULT_CHUNK,
    row_scale: Optional[jax.Array] = None,
    break_head_cap: bool = False,
    flat_cap: int = _INT32_FLAT_CAP,
) -> HybridSparse:
    """Build the hybrid layout on device from a DocSparse.

    With `row_scale` (vocab,) — the per-row constant value, sqrt(zeta)
    for the thresholded B — the factored layout is built instead: bf16
    binary head, no tail value arrays (see HybridSparse docstring). The
    caller guarantees sp's nonzeros satisfy val == row_scale[word].

    `break_head_cap` lifts the int32 flat-scatter row cap via the
    doc-blocked head scatter (see _scatter_head); `flat_cap` is the
    index budget (overridable only so tests can force blocking at
    small shapes)."""
    V, D = sp.vocab, sp.num_docs
    cap = max(flat_cap // (D + 1) - 1, 0)
    if break_head_cap:
        num_head = int(min(num_head, V))
    else:
        if cap < 8:
            raise ValueError(
                f"num_docs={D} exceeds the int32 flat-scatter head "
                f"capacity (max_head_rows={cap}); disable the dense head "
                "(dense_head_bytes=0), shard the docs axis, or set "
                "break_head_cap"
            )
        num_head = int(min(num_head, V, cap))
    head_words, is_head, rank = _head_select(sp, num_head)

    if row_scale is None:
        head, head_nnz = _build_head(
            sp, rank, is_head, num_head, D, flat_cap
        )
    else:
        head, head_nnz = _build_head_binary(
            sp, rank, is_head, num_head, D, flat_cap
        )
    head_nnz = int(head_nnz)

    # Tail plans: sizes need a host sync to fix static shapes.
    pos_d, padded_d, off_d = _tail_plan(sp.d_word, sp.d_doc, is_head, V, D)
    pos_w, padded_w, off_w = _tail_plan(sp.w_word, sp.w_word, is_head, V, V)
    Nt = int(jnp.sum(padded_d))
    Nw = int(jnp.sum(padded_w))
    Nt_pad = max(((Nt + chunk - 1) // chunk) * chunk, chunk)
    Nw_pad = max(((Nw + chunk - 1) // chunk) * chunk, chunk)

    if row_scale is None:
        td_word, td_val, td_odoc = _compact_tail(
            sp.d_word, sp.d_val, pos_d, off_d, V, Nt_pad
        )
        _, tw_val, tw_oword = _compact_tail(
            sp.w_word, sp.w_val, pos_w, off_w, V, Nw_pad
        )
        tw_doc = _compact_ids(sp.w_doc, pos_w, Nw_pad, D)
    else:
        td_val = tw_val = None
        td_word, td_odoc = _compact_tail_novals(
            sp.d_word, pos_d, off_d, Nt_pad, V
        )
        tw_doc, tw_oword = _compact_tail_novals(
            sp.w_doc, pos_w, off_w, Nw_pad, D
        )

    return HybridSparse(
        head_words=head_words,
        head=head,
        td_word=td_word,
        td_val=td_val,
        td_odoc=td_odoc,
        tw_doc=tw_doc,
        tw_val=tw_val,
        tw_oword=tw_oword,
        row_scale=(
            None if row_scale is None
            else jnp.asarray(row_scale, jnp.float32)
        ),
        vocab=V,
        num_docs=D,
        nnz=sp.nnz,
        head_nnz=head_nnz,
    )


def _tail_gather_octsum(
    gather_idx: jax.Array,
    vals: Optional[jax.Array],
    oct_seg: jax.Array,
    X: jax.Array,
    num_segments: int,
    chunk: int,
    init: Optional[jax.Array] = None,
) -> jax.Array:
    """Two-level sorted segment sum: gather rows, 8-to-1 reshape-reduce,
    then a scatter-add of octet sums. vals=None skips the per-entry
    multiply (factored mode: the scale lives in the gathered operand or
    is applied to the output). `init` overrides the zero accumulator —
    shard_map callers pass a device-varying zeros so the scan carry types
    match."""
    n = gather_idx.shape[0]
    chunk = min(chunk, n)
    assert n % chunk == 0
    nchunks = n // chunk
    W = X.shape[1]
    gi = gather_idx.reshape(nchunks, chunk)
    os = oct_seg.reshape(nchunks, chunk // 8)

    if vals is None:
        def body(acc, args):
            g_idx, seg = args
            g = jnp.take(X, g_idx, axis=0, fill_value=0.0)
            octs = jnp.sum(g.reshape(chunk // 8, 8, W), axis=1)
            acc = acc.at[seg].add(octs, indices_are_sorted=True)
            return acc, None

        xs = (gi, os)
    else:
        vv = vals.reshape(nchunks, chunk)

        def body(acc, args):
            g_idx, v, seg = args
            g = jnp.take(X, g_idx, axis=0, fill_value=0.0) * v[:, None]
            octs = jnp.sum(g.reshape(chunk // 8, 8, W), axis=1)
            acc = acc.at[seg].add(octs, indices_are_sorted=True)
            return acc, None

        xs = (gi, vv, os)

    if init is None:
        init = jnp.zeros((num_segments + 1, W), dtype=X.dtype)
    out, _ = jax.lax.scan(body, init, xs)
    return out


def _split_bf16x3(x: jax.Array) -> jax.Array:
    """f32 (n, W) -> bf16 (n, 3W) = [hi | mid | lo] with hi + mid + lo == x
    to f32 precision: three 8-bit-mantissa pieces carry the 24-bit f32
    mantissa. The rounding is reduce_precision, not an f32 -> bf16 -> f32
    round trip: XLA's GPU compiler removes such convert pairs when excess
    precision is allowed (its default), which would zero mid and lo and
    leave a bf16-truncated operand (~2e-3 relative error)."""
    rp = partial(jax.lax.reduce_precision, exponent_bits=8, mantissa_bits=7)
    hi = rp(x)
    r = x - hi
    mid = rp(r)
    lo = rp(r - mid)
    return jnp.concatenate([hi, mid, lo], axis=1).astype(jnp.bfloat16)


def _head_dot(head: jax.Array, other: jax.Array, transpose: bool) -> jax.Array:
    """head @ other (or head^T @ other with transpose=True) for the bf16
    binary head and a small f32 operand, exact to f32 rounding.

    A mixed bf16 x f32 dot makes XLA convert the whole head to an f32
    temporary on every call (twice the head's 2 bytes/cell), and at
    DEFAULT precision an f32 product may run in TF32 (~1e-3 relative
    error). So the SMALL operand is cast instead: split into three bf16
    pieces and contracted in ONE bf16 x bf16 product with f32
    accumulation. The head's 0/1 entries make every partial product
    exact; only the f32 accumulation rounds."""
    W = other.shape[1]
    contract = (0,) if transpose else (1,)
    out = jax.lax.dot_general(
        head,
        _split_bf16x3(other.astype(jnp.float32)),
        ((contract, (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    return out[:, :W] + out[:, W:2 * W] + out[:, 2 * W:]


@partial(jax.jit, static_argnames=("chunk",))
def h_bt_x(h: HybridSparse, X: jax.Array, chunk: int = DEFAULT_CHUNK) -> jax.Array:
    """B^T X: dense head matmul + tail two-level segment sum."""
    if h.row_scale is None:
        Xh = X[h.head_words]  # (R, W)
        out_head = jnp.matmul(h.head.T, Xh, precision=HI)  # (D, W)
        out = _tail_gather_octsum(
            h.td_word, h.td_val, h.td_odoc, X, h.num_docs, chunk
        )
    else:
        Xs = X[: h.vocab] * h.row_scale[:, None]
        Xh = Xs[h.head_words]  # (R, W)
        out_head = _head_dot(h.head, Xh, transpose=True)  # (D, W)
        out = _tail_gather_octsum(
            h.td_word, None, h.td_odoc, Xs, h.num_docs, chunk
        )
    return out[: h.num_docs] + out_head


@partial(jax.jit, static_argnames=("chunk",))
def h_b_y(h: HybridSparse, Y: jax.Array, chunk: int = DEFAULT_CHUNK) -> jax.Array:
    """B Y: tail scatter by word + dense head matmul into head rows."""
    if h.row_scale is None:
        out = _tail_gather_octsum(
            h.tw_doc, h.tw_val, h.tw_oword, Y, h.vocab, chunk
        )[: h.vocab]
        head_out = jnp.matmul(h.head, Y[: h.num_docs], precision=HI)
        return out.at[h.head_words].add(head_out)
    out = _tail_gather_octsum(
        h.tw_doc, None, h.tw_oword, Y, h.vocab, chunk
    )[: h.vocab] * h.row_scale[:, None]
    head_out = _head_dot(h.head, Y[: h.num_docs], transpose=False)  # (R, W)
    head_out = head_out * h.row_scale[h.head_words][:, None]
    return out.at[h.head_words].add(head_out)


@partial(jax.jit, static_argnames=("chunk",))
def h_gram_x(h: HybridSparse, X: jax.Array, chunk: int = DEFAULT_CHUNK) -> jax.Array:
    return h_b_y(h, h_bt_x(h, X, chunk), chunk)


@partial(jax.jit, static_argnames=("chunk",))
def h_doc_l2sq(h: HybridSparse, chunk: int = DEFAULT_CHUNK) -> jax.Array:
    if h.row_scale is None:
        head_l2 = jnp.sum(h.head * h.head, axis=0)  # (D,)
        vals2 = h.td_val * h.td_val
    else:
        s2 = h.row_scale * h.row_scale
        # head is binary: per-doc head l2 = s^2[head rows] . pattern
        head_l2 = _head_dot(
            h.head, s2[h.head_words][:, None], transpose=True
        )[: h.num_docs, 0]
        s2p = jnp.concatenate([s2, jnp.zeros((1,), jnp.float32)])
        vals2 = s2p[jnp.minimum(h.td_word, h.vocab)]
    n = vals2.shape[0]
    c = min(chunk, n)
    nchunks = n // c

    def body(acc, args):
        v2, seg = args
        octs = jnp.sum(v2.reshape(c // 8, 8), axis=1)
        return acc.at[seg].add(octs, indices_are_sorted=True), None

    tail, _ = jax.lax.scan(
        body,
        jnp.zeros((h.num_docs + 1,), jnp.float32),
        (vals2.reshape(nchunks, c), h.td_odoc.reshape(nchunks, c // 8)),
    )
    return head_l2 + tail[: h.num_docs]


def h_spmm_flops(h: HybridSparse, width: int) -> int:
    """FLOPs of one h_bt_x or h_b_y (the dense head counts its full matmul)."""
    tail_nnz = h.nnz - h.head_nnz
    return 2 * tail_nnz * width + 2 * h.num_head * h.num_docs * width


def h_to_doc_sparse_vals(h: HybridSparse):
    """Per-entry (word, doc, val) view of the tail in doc-sorted order
    (factored mode resolves vals from row_scale)."""
    doc = jnp.repeat(h.td_odoc, 8)
    if h.row_scale is not None:
        sp = jnp.concatenate(
            [h.row_scale, jnp.zeros((1,), jnp.float32)]
        )
        val = sp[jnp.minimum(h.td_word, h.vocab)]
    else:
        val = h.td_val
    return h.td_word, doc, val


# ---------------------------------------------------------------------------
# Fused construction: thresholded B directly from A in the factored hybrid
# layout (threshold_and_copy + to_hybrid in one pass, skipping the
# intermediate B COO entirely — roughly halves the full-size scatters).
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("num_docs",))
def _occupancy(word, doc, val, zetas, sel_p, num_docs: int):
    """Keep mask + per-doc occupancy/renumbering. `doc` is sorted
    (doc-sorted layout), so occupancy comes from kept-prefix sums sampled
    at doc boundaries — no segment_sum scatter (see _pad8_plan)."""
    from .bmatrix import _keep_mask

    keep = _keep_mask(word, val, zetas) & sel_p[doc]
    G = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(keep.astype(jnp.int32))]
    )
    bounds = jnp.searchsorted(
        doc, jnp.arange(num_docs + 1, dtype=doc.dtype), side="left"
    )
    kept_before = G[bounds]
    occ = (kept_before[1:] - kept_before[:-1]) > 0
    new_doc = jnp.cumsum(occ.astype(jnp.int32)) - 1
    frob_sq = jnp.sum(
        jnp.where(
            keep,
            jnp.concatenate([zetas, jnp.zeros((1,), jnp.float32)])[word],
            0.0,
        )
    )
    return keep, occ, new_doc, frob_sq


def _head_select_masked_body(w_word, w_val, w_doc, zetas, sel_p, vocab: int,
                             num_head: int):
    """Head selection over the post-threshold entries; computes the
    word-sorted keep mask in the same program (it was a 0.9 s chain of
    eager ops at the NYTimes shape) and returns it for reuse. Word counts
    come from kept-prefix sums at word boundaries (w_word sorted; see
    _pad8_plan). Also returns `rankx`, the fused rank/is_head table
    (rank for head words, -1 otherwise) the head build gathers once."""
    from .bmatrix import _keep_mask

    keep_w = _keep_mask(w_word, w_val, zetas) & sel_p[w_doc]
    G = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(keep_w.astype(jnp.int32))]
    )
    bounds = jnp.searchsorted(
        w_word, jnp.arange(vocab + 1, dtype=w_word.dtype), side="left"
    )
    kept_before = G[bounds]
    counts = kept_before[1:] - kept_before[:-1]
    _, head_words = jax.lax.top_k(counts, num_head)
    head_words = jnp.sort(head_words).astype(jnp.int32)
    is_head = jnp.zeros((vocab + 1,), bool).at[head_words].set(True)
    rank = jnp.zeros((vocab + 1,), jnp.int32).at[head_words].set(
        jnp.arange(num_head, dtype=jnp.int32)
    )
    rankx = jnp.where(is_head, rank, -1)
    return head_words, is_head, rank, keep_w, rankx


_head_select_masked = partial(jax.jit, static_argnames=("vocab", "num_head"))(
    _head_select_masked_body
)


@partial(jax.jit, static_argnames=("num_docs", "vocab"))
def _plans_masked(
    d_word, d_doc, keep_d, w_word, keep_w, is_head, num_docs: int, vocab: int
):
    """Both tail pad-plans in ONE program (the two eager _pad8_plan chains
    cost ~3.1 s at the NYTimes shape; fused they share passes over the
    entry arrays). The doc-side plan runs on RAW doc ids — the doc
    renumbering is monotone and dropped docs are empty segments, so the
    resulting positions are identical and the per-octet ids remap later
    (8x smaller). Returns positions, padded totals, block offsets, and
    the tail nnz."""
    mask_d = keep_d & ~is_head[d_word]
    mask_w = keep_w & ~is_head[w_word]
    pos_d, padded_d, off_d = _pad8_plan(mask_d, d_doc, num_docs)
    pos_w, padded_w, off_w = _pad8_plan(mask_w, w_word, vocab)
    return (
        pos_d, jnp.sum(padded_d), off_d,
        pos_w, jnp.sum(padded_w), off_w,
        jnp.sum(mask_d.astype(jnp.int32)),
    )


@partial(jax.jit, static_argnames=("vocab", "num_docs", "num_head",
                                   "nz_docs", "flat_cap"))
def _select_build_plan(
    d_word, d_doc, w_word, w_val, w_doc, zetas, sel_p, keep_d, ndp,
    vocab: int, num_docs: int, num_head: int, nz_docs: int,
    flat_cap: int = _INT32_FLAT_CAP,
):
    """Head selection + head build + both tail pad-plans in ONE program
    (they all run between the nz_docs sync and the tail-size sync; as
    three separate jits each re-streamed the 48M entry arrays — fusing
    lets XLA share the gathers and drops two kernel round trips)."""
    head_words, is_head, rank, keep_w, rankx = _head_select_masked_body(
        w_word, w_val, w_doc, zetas, sel_p, vocab, num_head
    )
    head, head_nnz = _build_head_masked_body(
        d_word, d_doc, keep_d, rankx, ndp, num_head, nz_docs, flat_cap
    )
    mask_d = keep_d & ~is_head[d_word]
    mask_w = keep_w & ~is_head[w_word]
    pos_d, padded_d, off_d = _pad8_plan(mask_d, d_doc, num_docs)
    pos_w, padded_w, off_w = _pad8_plan(mask_w, w_word, vocab)
    return (
        head_words, head, head_nnz,
        pos_d, jnp.sum(padded_d), off_d,
        pos_w, jnp.sum(padded_w), off_w,
        jnp.sum(mask_d.astype(jnp.int32)),
    )


def _build_head_masked_body(
    word, doc, keep, rankx, ndp, num_head: int, nz_docs: int,
    flat_cap: int = _INT32_FLAT_CAP,
):
    r = rankx[word]  # one gather for rank AND head membership
    hmask = keep & (r >= 0)
    rr = jnp.where(hmask, r, num_head)
    dd = jnp.where(hmask, ndp[doc], nz_docs)
    H = _scatter_head(rr, dd, None, num_head, nz_docs, flat_cap)
    return H, hmask.sum()


_build_head_masked = partial(
    jax.jit, static_argnames=("num_head", "nz_docs", "flat_cap")
)(_build_head_masked_body)


@partial(jax.jit, static_argnames=("vocab", "num_docs", "num_head",
                                   "flat_cap"))
def _select_build_plan_full(
    d_word, d_doc, d_val, w_word, w_val, w_doc, zetas,
    vocab: int, num_docs: int, num_head: int,
    flat_cap: int = _INT32_FLAT_CAP,
):
    """The no-sampling fused build: occupancy + head selection + head
    build + both tail pad-plans in ONE program with ONE host sync
    (the separate _occupancy program cost 1.36 s isolated at the NYTimes
    shape just to fix nz_docs for the head's static shape — instead the
    head is built over RENUMBERED doc columns at raw-D width, so its
    shape no longer depends on nz_docs; callers slice [:, :nz_docs]
    after the sync only when docs were actually dropped)."""
    from .bmatrix import _keep_mask

    D = num_docs
    keep_d = _keep_mask(d_word, d_val, zetas)
    # occupancy from kept-prefix sums at doc boundaries (see _pad8_plan)
    G = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(keep_d.astype(jnp.int32))]
    )
    bounds = jnp.searchsorted(
        d_doc, jnp.arange(D + 1, dtype=d_doc.dtype), side="left"
    )
    kept_before = G[bounds]
    occ = (kept_before[1:] - kept_before[:-1]) > 0
    new_doc = jnp.cumsum(occ.astype(jnp.int32)) - 1
    frob_sq = jnp.sum(
        jnp.where(
            keep_d,
            jnp.concatenate([zetas, jnp.zeros((1,), jnp.float32)])[d_word],
            0.0,
        )
    )
    sel_p = jnp.ones((D + 1,), bool)
    head_words, is_head, rank, keep_w, rankx = _head_select_masked_body(
        w_word, w_val, w_doc, zetas, sel_p, vocab, num_head
    )
    # head build at raw-D column width, renumbered columns: pads and
    # non-head entries go to column D (sliced off)
    r = rankx[d_word]
    hmask = keep_d & (r >= 0)
    rr = jnp.where(hmask, r, num_head)
    ndp = jnp.concatenate([new_doc, jnp.zeros((1,), jnp.int32)])
    dd = jnp.where(hmask, ndp[jnp.minimum(d_doc, D)], D)
    head = _scatter_head(rr, dd, None, num_head, D, flat_cap)
    head_nnz = hmask.sum()
    # tail plans on RAW ids (renumbering is monotone; see _plans_masked)
    mask_d = keep_d & ~is_head[d_word]
    mask_w = keep_w & ~is_head[w_word]
    pos_d, padded_d, off_d = _pad8_plan(mask_d, d_doc, D)
    pos_w, padded_w, off_w = _pad8_plan(mask_w, w_word, vocab)
    return (
        head_words, head, head_nnz, occ, new_doc, frob_sq,
        pos_d, jnp.sum(padded_d), off_d,
        pos_w, jnp.sum(padded_w), off_w,
        jnp.sum(mask_d.astype(jnp.int32)),
    )


def hybrid_from_thresholds(
    A: DocSparse,
    zetas: jax.Array,
    head_budget_bytes: int,
    chunk: int = DEFAULT_CHUNK,
    sample_rate=None,
    key=None,
    break_head_cap: bool = False,
    flat_cap: int = _INT32_FLAT_CAP,
):
    """B = threshold-and-copy(A, zetas) built DIRECTLY in the factored
    hybrid layout (bmatrix.threshold_and_copy + to_hybrid semantics fused:
    same keep rule round(val) >= zeta[word], same doc renumbering and
    original_cols, same post-threshold top-count head selection, values
    factored as row_scale = sqrt(zeta); reference
    src/sparseMatrix.cpp:1285-1435 + the cache-blocking idea of
    include/matUtils.h:244-268). Returns (HybridSparse, original_cols,
    frobenius_sq)."""
    from .bmatrix import _keep_mask, _sample_select

    V, D = A.vocab, A.num_docs
    zetas = jnp.asarray(zetas, jnp.float32)

    if sample_rate is None:
        # Single-sync fused path (no sampling): occupancy rides the same
        # program as head select/build and the pad plans, so the 48M
        # entry arrays stream ONCE and only one host round trip fixes the
        # static tail shapes. num_head is budgeted from A.num_docs rather
        # than nz_docs — head bytes stay <= budget (nz_docs <= num_docs)
        # and the two are identical whenever no doc loses all its entries
        # (the common case; sampling runs keep the nz_docs-exact budget
        # via the two-sync path below).
        cap = max(flat_cap // (D + 1) - 1, 0)
        if break_head_cap:
            num_head = int(
                min(V, max(8, head_budget_bytes // max(2 * D, 1)))
            )
        else:
            if cap < 8:
                raise ValueError(
                    f"num_docs={D} exceeds the int32 flat-scatter head "
                    f"capacity (max_head_rows={cap}); disable the dense "
                    "head (dense_head_bytes=0), shard the docs axis, or "
                    "set break_head_cap"
                )
            num_head = int(
                min(V, max(8, head_budget_bytes // max(2 * D, 1)), cap)
            )
        (head_words, head, head_nnz, occ, new_doc, frob_sq,
         pos_d, Nt_a, off_d, pos_w, Nw_a, off_w,
         tail_nnz) = _select_build_plan_full(
            A.d_word, A.d_doc, A.d_val, A.w_word, A.w_val, A.w_doc,
            zetas, V, D, num_head, flat_cap,
        )
        # one batched readback (each separate int()/np.asarray is a
        # host round trip)
        occ_h, Nt, Nw_a, head_nnz, tail_nnz, frob_sq = jax.device_get(
            (occ, Nt_a, Nw_a, head_nnz, tail_nnz, frob_sq)
        )
        nz_docs = int(occ_h.sum())
        original_cols = np.flatnonzero(occ_h).astype(np.int32)
        if nz_docs < D:
            head = head[:, :nz_docs]
        ndp = jnp.concatenate(
            [new_doc, jnp.full((1,), nz_docs, jnp.int32)]
        )
        Nt = int(Nt)
    else:
        assert key is not None
        keep_d0 = _keep_mask(A.d_word, A.d_val, zetas)
        sel = _sample_select(
            A.d_word, A.d_doc, keep_d0, zetas, D, int(sample_rate * D), key
        )
        sel_p = jnp.concatenate([sel, jnp.zeros((1,), bool)])

        keep_d, occ, new_doc, frob_sq = _occupancy(
            A.d_word, A.d_doc, A.d_val, zetas, sel_p, D
        )
        nz_docs = int(jnp.sum(occ))
        original_cols = np.flatnonzero(np.asarray(occ)).astype(np.int32)

        cap = max(flat_cap // (nz_docs + 1) - 1, 0)
        if break_head_cap:
            num_head = int(
                min(V, max(8, head_budget_bytes // max(2 * nz_docs, 1)))
            )
        else:
            if cap < 8:
                raise ValueError(
                    f"nz_docs={nz_docs} exceeds the int32 flat-scatter "
                    f"head capacity (max_head_rows={cap}); disable the "
                    "dense head (dense_head_bytes=0), shard the docs "
                    "axis, or set break_head_cap"
                )
            num_head = int(
                min(V, max(8, head_budget_bytes // max(2 * nz_docs, 1)),
                    cap)
            )
        ndp = jnp.concatenate(
            [new_doc, jnp.full((1,), nz_docs, jnp.int32)]
        )
        (head_words, head, head_nnz,
         pos_d, Nt_a, off_d, pos_w, Nw_a, off_w,
         tail_nnz) = _select_build_plan(
            A.d_word, A.d_doc, A.w_word, A.w_val, A.w_doc, zetas, sel_p,
            keep_d, ndp, V, D, num_head, nz_docs, flat_cap,
        )
        Nt = int(Nt_a)
    Nw = int(Nw_a)
    Nt_pad = max(((Nt + chunk - 1) // chunk) * chunk, chunk)
    Nw_pad = max(((Nw + chunk - 1) // chunk) * chunk, chunk)

    td_word, td_odoc = _compact_tail_oseg_remap(
        A.d_word, pos_d, off_d, ndp, Nt_pad, V
    )
    tw_doc, tw_oword = _compact_tail_remap(
        A.w_doc, ndp, pos_w, off_w, Nw_pad, nz_docs
    )

    nnz = int(head_nnz) + int(tail_nnz)
    h = HybridSparse(
        head_words=head_words,
        head=head,
        td_word=td_word,
        td_val=None,
        td_odoc=td_odoc,
        tw_doc=tw_doc,
        tw_val=None,
        tw_oword=tw_oword,
        row_scale=row_scale_from_zetas(zetas),
        vocab=V,
        num_docs=nz_docs,
        nnz=nnz,
        head_nnz=int(head_nnz),
    )
    return h, original_cols, float(frob_sq)
