"""Top-2-per-slot reservoir scan for top-k MIPS serving.

Reduction: a reservoir of R slots per query, slot = item_id mod R,
keeping the best TWO (score, id) pairs per slot. The final exact
`lax.top_k` runs over the (b, 2R) candidates.

Recall analysis (item ids ~ uniform over slots): a rank-i item is missed
only if >= 2 higher-ranked items share its slot, so E[missed among
top-k] ~= C(k, 3)/R^2 -> recall@100 ~= 0.99990 at R=4096, 0.999976 at
R=8192 (top-1 reservoirs would need R~65k for the same, which is why
two are kept).

Two implementations of the same scan, both scoring with bf16 operands
and f32 accumulation:

* `_scan_kernel` — Pallas through Triton. The grid runs over (query
  block, slot range); each program loops over every item tile for its
  own slots only, so its (q_block, slot_block) x 4 reservoir stays in
  registers, no state crosses programs, and no score tile reaches
  device memory. Query blocks are the fastest grid axis, so the
  programs that share a slot range read each table tile while it is in
  L2. What it costs is the table re-reads that L2 does not catch.
* `_scan_plain` — the blocked GEMM in jnp, reshaped to (b, tiles, R),
  top-2 over tiles, merged into the running reservoir: what XLA
  compiles, the CPU implementation and the kernel's reference.

`nmftpu.backend` picks between them. The oracle for both is the exact
blocked scan in retrieval/mips.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from nmftpu import backend

NEG = float("-inf")
# items per plain-scan step: bounds the (b, chunk) f32 score buffer
_PLAIN_CHUNK = 1 << 20
# slots per kernel program (see the tiling note in _scan_kernel)
_SLOT_BLOCK = 64


def _merge_top2(s1, i1, s2, i2, c1, j1, c2, j2):
    """Merge two top-2 lists per slot. (s, i) holds the lower ids, so it
    wins ties: the order a sequential scan keeps."""
    take = c1 > s1
    n1 = jnp.where(take, c1, s1)
    m1 = jnp.where(take, j1, i1)
    # second best: the loser of the first comparison against the
    # runner-up of the winning list; a is always from (s, i)
    a_s, a_i = jnp.where(take, s1, s2), jnp.where(take, i1, i2)
    b_s, b_i = jnp.where(take, c2, c1), jnp.where(take, j2, j1)
    a_wins = a_s >= b_s
    n2 = jnp.where(a_wins, a_s, b_s)
    m2 = jnp.where(a_wins, a_i, b_i)
    return n1, m1, n2, m2


def _kernel(wq_ref, h_ref, s1_ref, i1_ref, s2_ref, i2_ref, *, m_items,
            slots, ntiles):
    q_block, sb = s1_ref.shape
    s0 = pl.program_id(1) * sb
    wq = wq_ref[...]                                  # (q_block, r) bf16
    col = s0 + lax.broadcasted_iota(jnp.int32, (q_block, sb), 1)

    def tile(t, carry):
        s1, i1, s2, i2 = carry
        h = h_ref[:, pl.ds(t * slots + s0, sb)]       # (r, sb)
        s = pl.dot(wq, h.astype(jnp.bfloat16))        # f32 accumulate
        gid = t * slots + col
        s = jnp.where(gid < m_items, s, NEG)          # table padding
        beats1 = s > s1
        n2 = jnp.maximum(jnp.minimum(s, s1), s2)
        j2 = jnp.where(beats1, i1, jnp.where(s > s2, gid, i2))
        return (jnp.maximum(s, s1), jnp.where(beats1, gid, i1), n2, j2)

    init = (jnp.full((q_block, sb), NEG, jnp.float32),
            jnp.zeros((q_block, sb), jnp.int32),
            jnp.full((q_block, sb), NEG, jnp.float32),
            jnp.zeros((q_block, sb), jnp.int32))
    s1, i1, s2, i2 = lax.fori_loop(jnp.int32(0), jnp.int32(ntiles), tile,
                                   init)
    s1_ref[...] = s1
    i1_ref[...] = i1
    s2_ref[...] = s2
    i2_ref[...] = i2


def _scan_kernel(Wq, Hp, m_items, slots, q_block, slot_block, interpret):
    """(b, 2*slots) candidates (scores, ids) from the Triton scan. Wq is
    row-padded to a q_block multiple, Hp column-padded to a slots
    multiple; r, q_block and slot_block are powers of two >= 16."""
    b, r = Wq.shape
    ntiles = Hp.shape[1] // slots
    grid = (b // q_block, slots // slot_block)
    out_spec = pl.BlockSpec((q_block, slot_block), lambda i, j: (i, j))
    f32 = jax.ShapeDtypeStruct((b, slots), jnp.float32)
    i32 = jax.ShapeDtypeStruct((b, slots), jnp.int32)
    s1, i1, s2, i2 = pl.pallas_call(
        functools.partial(_kernel, m_items=m_items, slots=slots,
                          ntiles=ntiles),
        grid=grid,
        in_specs=[pl.BlockSpec((q_block, r), lambda i, j: (i, 0)),
                  pl.BlockSpec((r, Hp.shape[1]), lambda i, j: (0, 0))],
        out_specs=[out_spec] * 4,
        out_shape=[f32, i32, f32, i32],
        backend="triton",
        # q_block=128, slot_block=64 on 8 warps: the fastest of six
        # tilings timed at the serving shape on the H100 (PERF.md);
        # 128 x 128 asks for more shared memory than a block has
        compiler_params=plgpu.CompilerParams(num_warps=8, num_stages=3),
        interpret=interpret,
        name="mips_reservoir",
    )(Wq.astype(jnp.bfloat16), Hp)
    return (jnp.concatenate([s1, s2], axis=1),
            jnp.concatenate([i1, i2], axis=1))


def _scan_plain(Wq, Hp, m_items, slots):
    """The same (b, 2*slots) candidates from blocked XLA GEMMs."""
    b, _ = Wq.shape
    ntiles = Hp.shape[1] // slots
    per = max(1, min(ntiles, _PLAIN_CHUNK // slots))   # tiles per step
    wq = Wq.astype(jnp.bfloat16)
    slot_ids = jnp.arange(slots, dtype=jnp.int32)

    def chunk_top2(t0, n):
        h = lax.dynamic_slice_in_dim(Hp, t0 * slots, n * slots, axis=1)
        s = lax.dot_general(
            wq, h.astype(jnp.bfloat16), (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        ).reshape(b, n, slots)
        gid = (t0 + jnp.arange(n, dtype=jnp.int32))[:, None] * slots \
            + slot_ids
        s = jnp.where(gid < m_items, s, NEG)
        p1 = jnp.argmax(s, axis=1)                       # first max wins
        c1 = jnp.max(s, axis=1)
        s = jnp.where(jnp.arange(n)[None, :, None] == p1[:, None, :],
                      NEG, s)
        p2 = jnp.argmax(s, axis=1)
        c2 = jnp.max(s, axis=1)
        j1 = (t0 + p1.astype(jnp.int32)) * slots + slot_ids
        j2 = (t0 + p2.astype(jnp.int32)) * slots + slot_ids
        return c1, j1, c2, j2

    def merge(carry, cand):
        return _merge_top2(*carry, *cand)

    carry = (jnp.full((b, slots), NEG, jnp.float32),
             jnp.zeros((b, slots), jnp.int32),
             jnp.full((b, slots), NEG, jnp.float32),
             jnp.zeros((b, slots), jnp.int32))
    nfull, tail = divmod(ntiles, per)
    if nfull:
        carry = lax.fori_loop(
            0, nfull, lambda c, st: merge(st, chunk_top2(c * per, per)),
            carry)
    if tail:
        carry = merge(carry, chunk_top2(nfull * per, tail))
    s1, i1, s2, i2 = carry
    # a slot with no real item keeps filler id 0, as the kernel does
    i1 = jnp.where(s1 == NEG, 0, i1)
    i2 = jnp.where(s2 == NEG, 0, i2)
    return (jnp.concatenate([s1, s2], axis=1),
            jnp.concatenate([i1, i2], axis=1))


def _is_pow2(x: int) -> bool:
    return x >= 16 and x & (x - 1) == 0


def kernel_fits(r: int, slots: int) -> bool:
    """Shapes the Triton scan takes: power-of-two rank and slot count of
    at least 16 (Triton's block shapes and smallest dot)."""
    return _is_pow2(r) and _is_pow2(slots)


@functools.partial(
    jax.jit,
    static_argnames=("k", "slots", "q_block", "interpret", "m_items"),
)
def reservoir_topk_mips(Wq, H, k, slots=4096, seen=None, h_scale=None,
                        q_block=128, interpret=False, m_items=None):
    """Top-k MIPS via the top-2-per-slot reservoir scan.

    Wq: (b, r) f32/bf16 queries; H: (r, m) item table (f32, bf16 or
    int8 — int8 carries `h_scale` exactly as retrieval/mips._score_dot).
    seen: optional (b, S) padded item-id array, excluded EXACTLY from
    the returned top-k by the same oversampled drop as
    `topk_mips_excluded` (candidates = 2*slots >> k + S).
    m_items: true item count when H was PRE-padded to a slots multiple
    (serving pads once at table load; per-call padding would copy the
    multi-GB table every batch) — columns >= m_items never surface.
    interpret: run the Triton kernel in the Pallas interpreter (tests);
    otherwise `nmftpu.backend` picks the kernel or the plain scan.
    Returns (scores (b, k), indices (b, k)).
    """
    from nmftpu.retrieval.mips import _drop_seen

    Wq = jnp.asarray(Wq)
    H = jnp.asarray(H)
    b, r = Wq.shape
    m = H.shape[1] if m_items is None else m_items
    if seen is not None and k + seen.shape[1] > 2 * slots:
        raise ValueError(
            f"k + seen width = {k + seen.shape[1]} exceeds the "
            f"2*slots = {2 * slots} reservoir candidates; raise slots "
            "or trim the per-user seen lists"
        )
    if h_scale is not None and not jnp.issubdtype(H.dtype, jnp.integer):
        raise ValueError(
            "h_scale is only meaningful with an integer item table"
        )
    if h_scale is None and jnp.issubdtype(H.dtype, jnp.integer):
        raise ValueError(
            "an integer item table needs its quantization scale "
            "(h_scale)"
        )
    vector_scale = h_scale is not None and jnp.asarray(h_scale).ndim == 1
    if vector_scale:
        # per-dimension scales (true H = diag(h_scale) @ H_int8) fold
        # into the QUERY side — free on the scan (see mips._score_dot)
        Wq = Wq.astype(jnp.float32) * jnp.asarray(h_scale)
    mp = -(-H.shape[1] // slots) * slots
    Hp = H if mp == H.shape[1] else jnp.pad(
        H, ((0, 0), (0, mp - H.shape[1])))
    use_kernel = interpret or (backend.use_kernel("mips_reservoir")
                               and kernel_fits(r, slots))
    if use_kernel:
        slot_block = min(_SLOT_BLOCK, slots)
        bp = -(-b // q_block) * q_block
        Wqp = Wq if bp == b else jnp.pad(Wq, ((0, bp - b), (0, 0)))
        cand_s, cand_i = _scan_kernel(Wqp, Hp, m, slots, q_block,
                                      slot_block, interpret)
        cand_s, cand_i = cand_s[:b], cand_i[:b]
    else:
        cand_s, cand_i = _scan_plain(Wq, Hp, m, slots)
    if h_scale is not None and not vector_scale:
        cand_s = cand_s * h_scale
    if seen is not None:
        return _drop_seen(cand_s, cand_i, jnp.asarray(seen), k)
    top_s, pos = lax.top_k(cand_s, k)
    return top_s, jnp.take_along_axis(cand_i, pos, axis=1)
