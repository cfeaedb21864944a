"""Two-phase exact top-k search: bucket maxima → select → rescore.

The hot loop of the engine (SURVEY.md §7 "fused top-k"). The
single-pass scan in fenix_tpu.ops.distance materializes a [Q, block]
score tile in HBM per step and runs ``lax.top_k`` against it — sort
cost and tile traffic dominate. This module splits the search:

**Phase 1 (bandwidth-bound):** one pass over the corpus emits, per
``bucket`` rows (128, or 32 for large query batches), the max of the
fused score ``s = (q·v) · aux_mul + aux_add`` — one formula for all
metrics, with predicate/probe masks as −inf in ``aux_add``. Three
lowerings: an unblocked dot at small Q (bandwidth-bound), the fused
Pallas kernel at large Q on the GPU (score tiles in registers, no
[N, Q] intermediate; PERF.md has its times against the XLA forms),
and a blocked ``lax.scan`` as the shape-generic fallback. Scan dtype
options: fp32 (exact), bf16 copy, int8 per-row-quantized copy
(selection-only precision; opt-in).

**Phase 2 (small):** top ``k + pad`` buckets per query via
hierarchical selection (a flat top-k over every bucket is the costly
part), gather those buckets' rows, rescore exactly in fp32 (Precision.HIGHEST), merge.

Phase-1 matmul precision (fp32 mode): on the GPU an f32 dot without
``HIGHEST`` runs in TF32 (10-bit mantissa), and ``HIGH`` is the same
as ``DEFAULT`` there. TF32 selection measurably breaks the exact
contract: the near-tie suite (tests/test_topk_adversarial.py) fails
at Q=256 with a TF32 phase 1 on an H100 and passes with 3xTF32. So the
fused kernel runs fp32 as 3xTF32 (three TF32 products, about fp32
accuracy) and the XLA fp32 phase-1 dots run ``HIGHEST``, which costs
nothing at the small-Q one-shot (bandwidth-bound). The BUCKET_PAD
candidate margin covers what rounding remains; returned distances are
always fp32-true from the ``HIGHEST`` phase-2 rescore. The bf16 and
int8 scan copies are approximate selection by contract.

Exactness: a bucket containing a true top-k element has bucket-max ≥
that element's score, and at most k buckets hold values ≥ the k-th
best, so the top-k buckets cover the true top-k (ties resolve to the
earliest bucket under ``lax.top_k``'s stable order → smallest row id,
the engine's deterministic tie rule; the IVF-clustered kernel enforces
the id rule explicitly via topk_values_min_id).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from fenix_tpu.ops.distance import NEG_INF, canonical_metric, normalize

BUCKET = 128  # rows per bucket
# Finer rescore granularity for big query batches: phase-2 gather
# traffic is kp·bucket·D per query. Both sizes and the switch point
# were tuned on the previous accelerator and are unmeasured on the
# H100 (ROADMAP S3).
BUCKET_LARGE_Q = 32
_BUCKET_SWITCH_Q = 64  # above this query count use BUCKET_LARGE_Q
BUCKET_PAD = 8  # extra buckets gathered for fp-rounding safety

# Phase-1 strategy: a single unblocked dot streams the corpus in one
# pass but materializes a [N, Q] score tile in device memory, so it
# only serves small batches; above ONESHOT_MAX_Q the fused kernel takes
# over on the GPU, and a blocked scan with a [Q, block] step tile of
# FUSABLE_TILE_BYTES elsewhere. The three sizes below were tuned on
# the previous accelerator; the H100 measurement of the kernel against
# both XLA forms is in PERF.md, and the sizes themselves are unmeasured
# on the H100 (ROADMAP S2).
ONESHOT_INTERMEDIATE_CAP = 4 << 30  # bytes of [N, Q] tile tolerated
ONESHOT_MAX_Q = 32  # above this the [N, Q] tile outweighs the corpus read
FUSABLE_TILE_BYTES = 8 << 20  # per-step [Q, block] tile target
_RESCORE_GATHER_CAP = 2 << 30  # phase-2 [Q, kp, 128, D] gather staging cap


def _fusable_block(n: int, qt: int, requested: int | None = None) -> int:
    """Largest power-of-two row block whose [qt, block] f32 step tile
    fits FUSABLE_TILE_BYTES and divides ``n`` (corpora are padded to 16384-row
    multiples upstream, so powers of two up to 16384 always divide)."""
    want = requested or max(FUSABLE_TILE_BYTES // (4 * qt), BUCKET)
    cand = min(want, n)
    while cand > BUCKET and n % cand != 0:
        cand //= 2
    return cand


def pack_result(dist: jax.Array, ids: jax.Array) -> jax.Array:
    """[Q,k] f32 + [Q,k] i32 → [2,Q,k] **int32** (distances bitcast).

    One device→host fetch instead of two — each readback pays a host
    round trip. The carrier dtype must be integer: bitcasting small
    ints into float32 yields denormals, which flush-to-zero arithmetic
    would corrupt; float bits ride through an int array unharmed."""
    return jnp.stack([jax.lax.bitcast_convert_type(dist, jnp.int32), ids])


def unpack_result(packed) -> tuple:
    import numpy as np

    from fenix_tpu.utils import profiling

    with profiling.annotate("fenix.fetch"):  # device→host readback
        packed = np.asarray(packed)
    return packed[0].view(np.float32), packed[1]


# -- metric preparation ----------------------------------------------------


def prepare_queries(queries: jax.Array, metric: str) -> jax.Array:
    """Query-side transform so phase-1 score is ``q'·v·aux_mul + aux_add``."""
    metric = canonical_metric(metric)
    if metric == "l2":
        return 2.0 * queries
    if metric == "cosine":
        return normalize(queries)
    return queries


@functools.partial(jax.jit, static_argnames=("metric",))
def prepare_aux(
    corpus: jax.Array, mask: jax.Array | None, metric: str
) -> tuple[jax.Array, jax.Array]:
    """Per-row (aux_mul, aux_add) for the fused score.

    l2:     s = 2·q·v − ‖v‖²          (order = −dist² order)
    cosine: s = q̂·v / ‖v‖            (order = cos order)
    dot:    s = q·v
    Masked rows get aux_add = −inf. Computed once per (corpus, mask,
    metric) and cached by the engine next to the corpus blocks.

    jit at the def site: run eagerly, ``jnp.square(corpus)`` allocates
    a second corpus-sized array, so a corpus above half the device
    memory could never be served; fused, only the [N] outputs are new.
    """
    metric = canonical_metric(metric)
    sq = jnp.sum(jnp.square(corpus), axis=-1)  # [N]
    if metric == "l2":
        aux_mul = jnp.ones_like(sq)
        aux_add = -sq
    elif metric == "cosine":
        aux_mul = 1.0 / jnp.maximum(jnp.sqrt(sq), 1e-12)
        aux_add = jnp.zeros_like(sq)
    else:
        aux_mul = jnp.ones_like(sq)
        aux_add = jnp.zeros_like(sq)
    if mask is not None:
        aux_add = jnp.where(mask, aux_add, NEG_INF)
    return aux_mul, aux_add


@jax.jit
def quantize_corpus_int8(corpus: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Per-row symmetric int8 quantization: ``v ≈ sv · v8``.

    Returns (v8 [N, D] int8, sv [N] f32). Quarter the scan traffic of
    fp32; phase 2 always rescores in fp32 so returned distances are
    exact — only bucket *selection* sees quantization error (recall ≈ 1
    with the BUCKET_PAD margin; opt-in via the executor's
    ``precision="int8"`` knob, same contract as bf16).

    jit at the def site: called eagerly on a multi-GB corpus the
    unfused divide/round/clip chain materializes ~3 corpus-sized fp32
    intermediates and OOMs a chip the corpus itself fits comfortably
    (hit at 2M×768 on 16 GB); fused, the only new allocations are the
    int8 copy and the [N] scale. Inside other jits it inlines."""
    sv = jnp.max(jnp.abs(corpus), axis=-1) / 127.0
    sv = jnp.maximum(sv, 1e-30)  # zero rows quantize to zeros
    v8 = jnp.clip(jnp.round(corpus / sv[:, None]), -127, 127).astype(jnp.int8)
    return v8, sv


def quantize_rows_int8_np(block) -> tuple:
    """Host (numpy) mirror of :func:`quantize_corpus_int8`: same max/127
    scale, same 1e-30 zero-row floor, same round+clip. THE single
    host-side quantizer — session.int8_solo and the residency streaming
    path both call it, so there is exactly one host implementation to
    keep in sync with the device one above (round-4 review finding:
    three hand copies of these constants). Host and device scales can
    differ by 1 ulp (XLA folds /127 into a reciprocal multiply) — the
    serving contract is unaffected because final distances are always
    fp32-rescored against the SAME scales that produced the codes."""
    import numpy as np

    block = np.asarray(block, np.float32)
    sv = np.maximum(
        np.abs(block).max(axis=1, initial=0.0) / 127.0, 1e-30
    ).astype(np.float32)
    v8 = np.clip(np.round(block / sv[:, None]), -127, 127).astype(np.int8)
    return v8, sv


def quantize_queries_int8(queries_p: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Per-query symmetric int8 quantization of *prepared* queries.

    Returns (q8 [Q, D] int8, inv_sq [Q] f32). The per-query scale is a
    positive constant within each query's score row, so dividing
    ``aux_add`` by it (instead of multiplying the dot) preserves the
    per-query score ORDER exactly in real arithmetic."""
    sq = jnp.max(jnp.abs(queries_p), axis=-1) / 127.0
    sq = jnp.maximum(sq, 1e-30)
    q8 = jnp.clip(jnp.round(queries_p / sq[:, None]), -127, 127).astype(jnp.int8)
    return q8, 1.0 / sq


def bucket_scores_scan_int8(
    q8: jax.Array,  # [QT, D] int8
    corpus8: jax.Array,  # [N, D] int8
    aux_mul_s: jax.Array,  # [N] f32 — aux_mul · sv (corpus scale folded in)
    aux_add: jax.Array,  # [N] f32
    inv_sq: jax.Array,  # [QT] f32 — per-query 1/scale
    bucket: int = BUCKET,
) -> jax.Array:  # [QT, N // bucket]
    """int8 phase 1: s8[q,i] = (q8·v8)·sv_i·aux_mul_i + aux_add_i/sq_q.

    The dot runs int8×int8; scales fold into the f32 FMA epilogue. Per
    query this is the exact score divided by sq_q — a positive
    constant — so bucket ranking matches fp32 up to int8 rounding of
    the dot.

    Accumulation dtype: f32 when d ≤ 1024 (127²·d < 2²⁴ ⇒ every
    partial sum is an exactly-representable integer — bitwise equal to
    i32), i32 above. The f32 form gives the epilogue the same shape as
    the fp32 path, which XLA can fuse into the dot's consumer."""
    n, d = corpus8.shape
    qt = q8.shape[0]
    acc_t = jnp.float32 if d <= 1024 else jnp.int32

    def fuse(s32, mb, ab):
        s = s32.astype(jnp.float32) * mb[None, :] + ab[None, :] * inv_sq[:, None]
        return s.reshape(qt, -1, bucket).max(axis=-1)

    # At large Q the oneshot's [N, QT] intermediate costs more than
    # the corpus read: the blocked scan avoids it (callers on the GPU
    # take the fused kernel before reaching here).
    if qt <= ONESHOT_MAX_Q and n * qt * 4 <= ONESHOT_INTERMEDIATE_CAP:
        s32 = jax.lax.dot_general(
            q8,
            corpus8,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=acc_t,
        )  # [QT, N]
        return fuse(s32, aux_mul_s, aux_add)

    block_rows = _fusable_block(n, qt)
    if n % block_rows != 0 or n == block_rows:
        # awkward n (tiny shards): fall back to one unblocked dot —
        # same fallback as the fp32 twin
        s32 = jax.lax.dot_general(
            q8,
            corpus8,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=acc_t,
        )
        return fuse(s32, aux_mul_s, aux_add)
    nb = max(n // block_rows, 1)
    xs = (
        corpus8.reshape(nb, block_rows, d),
        aux_mul_s.reshape(nb, block_rows),
        aux_add.reshape(nb, block_rows),
    )

    def body(_, x):
        vb, mb, ab = x
        s32 = jax.lax.dot_general(
            q8,
            vb,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=acc_t,
        )  # [QT, block]
        return None, fuse(s32, mb, ab)

    _, stacked = jax.lax.scan(body, None, xs)
    return jnp.transpose(stacked, (1, 0, 2)).reshape(qt, n // bucket)


def scores_to_distances(scores: jax.Array, queries: jax.Array, metric: str) -> jax.Array:
    """Exact distance from fused score (reference coder.py:38-50 values)."""
    metric = canonical_metric(metric)
    if metric == "l2":
        uu = jnp.sum(jnp.square(queries), axis=-1, keepdims=True)  # [Q, 1]
        return jnp.sqrt(jnp.maximum(uu - scores, 0.0))
    if metric == "cosine":
        return 0.5 - 0.5 * scores
    return -scores


# -- phase 1: bucket maxima ------------------------------------------------


def _xla_precision(acc) -> jax.lax.Precision:
    """Phase-1 XLA dot precision: true fp32 for fp32 scans (see the
    module docstring), the native rate for bf16."""
    return jax.lax.Precision.HIGHEST if acc == jnp.float32 else jax.lax.Precision.DEFAULT


def bucket_scores_xla(
    queries_p: jax.Array,  # [QT, D] prepared
    corpus: jax.Array,  # [N, D]
    aux_mul: jax.Array,  # [N]
    aux_add: jax.Array,  # [N]
    bucket: int = BUCKET,
) -> jax.Array:  # [QT, N // bucket]
    """Unblocked phase 1: one dot over the whole corpus.

    The production path for small query batches: one pass over the
    corpus, where a blocked ``lax.scan`` pays per step. The [QT, N]
    score tile it materializes costs QT·4/(D·itemsize) of the corpus bytes
    in extra traffic — bucket_scores_scan switches forms past
    ONESHOT_MAX_Q and ONESHOT_INTERMEDIATE_CAP."""
    # bf16 corpus → bf16 accumulate + bf16 score tile: halves the
    # materialized [QT, N] intermediate (selection-only precision;
    # rescore is fp32 upstream). fp32 corpus → HIGHEST: at Q ≤ 32 the
    # dot is bandwidth-bound, so true fp32 costs nothing over TF32.
    acc = jnp.bfloat16 if corpus.dtype == jnp.bfloat16 else jnp.float32
    s = jax.lax.dot_general(
        queries_p,
        corpus,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=acc,
        precision=_xla_precision(acc),
    )
    s = s * aux_mul[None, :].astype(acc) + aux_add[None, :].astype(acc)
    qt, n = s.shape
    return s.reshape(qt, n // bucket, bucket).max(axis=-1).astype(jnp.float32)


# -- large-Q fused kernel (Pallas, Triton route) -----------------------------
#
# For big query batches neither XLA form is free on the GPU: the one-shot
# dot writes and re-reads an [N, Q] f32 score tile (4 GB at Q=1024 over
# 1M rows, against a 512 MB corpus), and the blocked ``lax.scan`` runs
# N/block sequential steps whose bucket-max cuBLAS cannot fuse into the
# matmul. This kernel keeps each [BN, BQ] score tile in registers and
# writes only its [BN/bucket, BQ] bucket maxima.
#
# One program per (query tile, row block); nothing carries between
# programs. The query tile is grid axis 0, which the GPU launches
# fastest, so the programs that share a corpus block run back to back
# and re-read it from L2 rather than HBM.

# Tiles from a sweep at 1M × 128, Q=1024 on an H100 (PERF.md): 8 warps
# beat 4 by 1.6× in fp32; 64-row blocks and a fourth stage did not help.
_TRITON_BN = 128  # corpus rows per program; a multiple of both buckets
_TRITON_BK = {4: 64, 2: 64, 1: 128}  # K-chunk width by itemsize
_TRITON_WARPS = 8
_TRITON_STAGES = 3
# 3xTF32: plain TF32 fails the near-tie suite on the card (module docstring)
_FP32_DOT = jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3


def _triton_tiles(qt: int, d: int, itemsize: int) -> tuple[int, int]:
    """(query tile, K-chunk) for a batch of ``qt`` queries of width ``d``."""
    bq = 128 if qt > 64 else 64
    bk = max(16, min(_TRITON_BK[itemsize], _next_pow2(d)))
    return bq, bk


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def _make_triton_kernel(d: int, bk: int, bucket: int, int8_mode: bool, precision):
    """Kernel factory: [BN, BQ] = corpus block · query tileᵀ, accumulated
    over D in ``bk`` chunks (a pipelined loop over the full chunks, then
    one masked tail chunk when ``bk`` does not divide ``d``), then the
    scale/shift and the per-``bucket`` max in the epilogue."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    n_full, tail = divmod(d, bk)

    def kernel(q_ref, v_ref, mul_ref, add_ref, *rest):
        inv_sq_ref, out_ref = rest if int8_mode else (None, rest[0])
        bq, bn = q_ref.shape[0], v_ref.shape[0]
        acc_t = jnp.int32 if int8_mode else jnp.float32

        def chunk(v, q):
            return pl.dot(v, q, trans_b=True, precision=precision).astype(acc_t)

        def body(kk, acc):
            cols = pl.ds(pl.multiple_of(kk * bk, bk), bk)
            return acc + chunk(v_ref[:, cols], q_ref[:, cols])

        acc = jax.lax.fori_loop(0, n_full, body, jnp.zeros((bn, bq), acc_t))
        if tail:
            cols = pl.ds(n_full * bk, bk)
            ok = (jnp.arange(bk) < tail)[None, :]
            v = plgpu.load(v_ref.at[:, cols], mask=ok, other=0)
            q = plgpu.load(q_ref.at[:, cols], mask=ok, other=0)
            acc = acc + chunk(v, q)

        add = add_ref[...][:, None]
        if int8_mode:
            add = add * inv_sq_ref[...][None, :]
        s = acc.astype(jnp.float32) * mul_ref[...][:, None] + add  # [BN, BQ]
        out_ref[...] = s.reshape(bn // bucket, bucket, bq).max(axis=1)

    return kernel


def bucket_scores_triton(
    queries_p: jax.Array,  # [QT, D] f32/bf16 — or int8 with ``inv_sq``
    corpus: jax.Array,  # [N, D] same dtype
    aux_mul: jax.Array,  # [N] f32 (int8: aux_mul · sv)
    aux_add: jax.Array,  # [N] f32
    inv_sq: jax.Array | None = None,  # [QT] f32 — int8 path only
    interpret: bool = False,
    bucket: int = BUCKET,
) -> jax.Array:  # [N // bucket, QT] — feed this layout to topk_buckets_nbq
    """Fused matmul + bucket-max phase 1 (Pallas, ``backend="triton"``).

    Dot types: fp32 runs as TF32 (selection only, see the module
    docstring), bf16 as bf16, int8 as int8×int8 → int32 with the row and
    query scales applied in the epilogue. Any batch size: the query
    axis is zero-padded up to the tile and sliced off again. ``N`` must
    be a multiple of ``_TRITON_BN`` (see :func:`_bigq_eligible`)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    qt, d = queries_p.shape
    n = corpus.shape[0]
    int8_mode = inv_sq is not None
    bn = _TRITON_BN
    assert n % bn == 0 and bn % bucket == 0, (n, bucket)
    bq, bk = _triton_tiles(qt, d, corpus.dtype.itemsize)
    qp = -(-qt // bq) * bq
    if qp != qt:
        queries_p = jnp.concatenate(
            [queries_p, jnp.zeros((qp - qt, d), queries_p.dtype)]
        )
        if int8_mode:
            inv_sq = jnp.concatenate([inv_sq, jnp.ones((qp - qt,), inv_sq.dtype)])
    # interpret mode runs the body through XLA:CPU, which has no TF32
    precision = (
        None
        if int8_mode or corpus.dtype != jnp.float32
        else (jax.lax.Precision.HIGHEST if interpret else _FP32_DOT)
    )
    kernel = _make_triton_kernel(d, bk, bucket, int8_mode, precision)
    dp = _next_pow2(d)  # block width; loads never reach past ``d``
    in_specs = [
        pl.BlockSpec((bq, dp), lambda j, i: (j, 0)),
        pl.BlockSpec((bn, dp), lambda j, i: (i, 0)),
        pl.BlockSpec((bn,), lambda j, i: (i,)),
        pl.BlockSpec((bn,), lambda j, i: (i,)),
    ]
    args = [queries_p, corpus, aux_mul, aux_add]
    if int8_mode:
        in_specs.append(pl.BlockSpec((bq,), lambda j, i: (j,)))
        args.append(inv_sq)

    itemsize = corpus.dtype.itemsize
    out = pl.pallas_call(
        kernel,
        grid=(qp // bq, n // bn),
        in_specs=in_specs,
        out_specs=pl.BlockSpec((bn // bucket, bq), lambda j, i: (i, j)),
        out_shape=jax.ShapeDtypeStruct((n // bucket, qp), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=_TRITON_WARPS, num_stages=_TRITON_STAGES
        ),
        cost_estimate=pl.CostEstimate(
            flops=2 * n * qp * d,
            bytes_accessed=n * d * itemsize + n * 8 + qp * d * itemsize
            + (n // bucket) * qp * 4,
            transcendentals=0,
        ),
        interpret=interpret,
        name="fenix_bucket_max",
    )(*args)
    return out[:, :qt]


def _bigq_eligible(n: int) -> bool:
    """Whether phase 1 for a batch above ONESHOT_MAX_Q takes the fused
    kernel: yes on the GPU when the corpus tiles into row blocks; never
    on the CPU, where XLA serves every batch (tests run the kernel in
    interpret mode explicitly). Any other platform is an error — this
    engine has no kernel for it and will not guess."""
    platform = jax.default_backend()
    if platform == "cpu":
        return False
    if platform != "gpu":
        raise NotImplementedError(f"no phase-1 route for platform {platform!r}")
    return n % _TRITON_BN == 0


def bucket_scores_scan(
    queries_p: jax.Array,  # [QT, D]
    corpus: jax.Array,  # [N, D]
    aux_mul: jax.Array,
    aux_add: jax.Array,
    bucket: int = BUCKET,
) -> jax.Array:  # [QT, N // bucket]
    """XLA phase 1: one unblocked dot when the [N, QT] intermediate is
    affordable, else a ``lax.scan`` over row blocks (matmul →
    scale/shift → bucket-max per step). Callers on the GPU take the
    fused kernel for large batches before reaching here.

    No per-block ``top_k``, no cross-block carry: selection happens
    once at the end (topk_two_phase).
    """
    n, d = corpus.shape
    qt = queries_p.shape[0]

    # bf16 corpus → bf16 score tiles: halves the materialized s-tile
    # traffic; selection-only precision (the final top_k over bucket
    # maxima happens in f32 upstream).
    acc_dtype = jnp.bfloat16 if corpus.dtype == jnp.bfloat16 else jnp.float32
    acc_bytes = 2 if acc_dtype == jnp.bfloat16 else 4

    if qt <= ONESHOT_MAX_Q and n * qt * acc_bytes <= ONESHOT_INTERMEDIATE_CAP:
        return bucket_scores_xla(queries_p, corpus, aux_mul, aux_add, bucket)

    block_rows = _fusable_block(n, qt)
    if n % block_rows != 0 or n == block_rows:
        return bucket_scores_xla(queries_p, corpus, aux_mul, aux_add, bucket)
    nb = n // block_rows

    xs = (
        corpus.reshape(nb, block_rows, d),
        aux_mul.reshape(nb, block_rows),
        aux_add.reshape(nb, block_rows),
    )

    def body(_, x):
        vb, mb, ab = x
        s = jax.lax.dot_general(
            queries_p,
            vb,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=acc_dtype,
            precision=_xla_precision(acc_dtype),
        )
        s = s * mb[None, :].astype(acc_dtype) + ab[None, :].astype(acc_dtype)
        out = s.reshape(qt, block_rows // bucket, bucket).max(axis=-1)
        return None, out

    _, stacked = jax.lax.scan(body, None, xs)  # [nb, QT, block//bucket]
    out = jnp.transpose(stacked, (1, 0, 2)).reshape(qt, n // bucket)
    return out.astype(jnp.float32)


def bucket_scores_scan_probed(
    queries_p: jax.Array,  # [QT, D] — prepared fp32 / bf16 / q8 (int8)
    corpus: jax.Array,  # [N, D] — fp32 / bf16 scan copy / v8 (int8)
    aux_mul: jax.Array,  # [N] (int8: aux_mul · sv, corpus scale folded)
    aux_add: jax.Array,
    coded: jax.Array,  # [N] int32 cell ids
    cells: jax.Array,  # [QT, P] per-query probe cells
    block_rows: int | None = None,
    bucket: int = BUCKET,
    inv_sq: jax.Array | None = None,  # [QT] — int8 per-query 1/scale
) -> jax.Array:  # [QT, N // bucket]
    """Phase 1 with per-query IVF probe masks applied inside the scan
    (reference index.py:113-126 semantics, per query). Blocked like
    bucket_scores_scan; the per-query probe mask rules out the
    unblocked-dot fast path (the [QT, block, P] compare must stay one
    step-sized tile).

    Scan-precision variants mirror the unprobed twins: a bf16 ``corpus``
    halves traffic with a bf16 accumulate; an int8 ``corpus`` (pass
    ``inv_sq`` and fold sv into ``aux_mul``) quarters it with the same
    score form as bucket_scores_scan_int8."""
    n, d = corpus.shape
    qt = queries_p.shape[0]
    int8_mode = corpus.dtype == jnp.int8
    if int8_mode:
        acc = jnp.float32 if d <= 1024 else jnp.int32
    elif corpus.dtype == jnp.bfloat16:
        acc = jnp.bfloat16
    else:
        acc = jnp.float32
    block_rows = _fusable_block(n, qt, block_rows)
    nb = max(n // block_rows, 1)

    xs = (
        corpus.reshape(nb, block_rows, d),
        aux_mul.reshape(nb, block_rows),
        aux_add.reshape(nb, block_rows),
        coded.reshape(nb, block_rows),
    )

    def body(_, x):
        vb, mb, ab, cb = x
        s = jax.lax.dot_general(
            queries_p,
            vb,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=acc,
            precision=_xla_precision(acc),
        )
        if int8_mode:
            s = s.astype(jnp.float32) * mb[None, :] + ab[None, :] * inv_sq[:, None]
        else:
            s = s * mb[None, :].astype(acc) + ab[None, :].astype(acc)
        probe_ok = (cb[None, :, None] == cells[:, None, :]).any(axis=-1)  # [QT, B]
        s = jnp.where(probe_ok, s, jnp.asarray(NEG_INF, s.dtype))
        out = s.reshape(qt, block_rows // bucket, bucket).max(axis=-1)
        return None, out

    _, stacked = jax.lax.scan(body, None, xs)
    return jnp.transpose(stacked, (1, 0, 2)).reshape(qt, n // bucket).astype(jnp.float32)


# Group width for hierarchical bucket selection (one lane tile).
_SEL_GROUP = 128


def topk_buckets(bucket_max: jax.Array, kp: int) -> jax.Array:
    """Exact top-``kp`` bucket indices per query, hierarchical.

    ``lax.top_k`` over the full [Q, N/128] bucket-max row was the
    single most expensive op at large Q on the previous accelerator,
    whose top-k is sort-based (unmeasured on the H100). Instead:
    group-max over 128-bucket groups → top-kp *groups* (at most
    kp groups can hold a value ≥ the kp-th best, same coverage argument
    as the bucket trick itself) → gather those groups' bucket maxima →
    top-kp over kp·128 candidates. Stable order is preserved: groups
    are gathered in ascending index order, so ``lax.top_k``'s
    earliest-on-tie rule keeps resolving ties to the smallest bucket id.

    Returns bucket indices [Q, kp] (scores are not needed upstream).
    """
    q, nb = bucket_max.shape
    if kp > _SEL_GROUP or nb < 8 * _SEL_GROUP or nb <= 2 * kp * _SEL_GROUP:
        _, bidx = jax.lax.top_k(bucket_max, kp)
        return bidx

    pad = (-nb) % _SEL_GROUP
    if pad:
        bucket_max = jnp.concatenate(
            [bucket_max, jnp.full((q, pad), NEG_INF, bucket_max.dtype)], axis=1
        )
    g = bucket_max.shape[1] // _SEL_GROUP
    grouped = bucket_max.reshape(q, g, _SEL_GROUP)
    gmax = grouped.max(axis=-1)  # [Q, g]

    kg = min(kp, g)
    _, gidx = jax.lax.top_k(gmax, kg)  # [Q, kg], stable
    gidx = jnp.sort(gidx, axis=-1)  # ascending → candidate order = id order

    cand = jnp.take_along_axis(grouped, gidx[:, :, None], axis=1)  # [Q, kg, 128]
    cand = cand.reshape(q, kg * _SEL_GROUP)
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, 1, _SEL_GROUP), 2)
    cand_ids = (gidx[:, :, None] * _SEL_GROUP + lane).reshape(q, kg * _SEL_GROUP)

    _, pos = jax.lax.top_k(cand, kp)
    bidx = jnp.take_along_axis(cand_ids, pos, axis=1)
    # padding groups carry −inf and are only picked when fewer than kp
    # real buckets exist; clamp their synthetic ids into range
    return jnp.minimum(bidx, nb - 1)


def _top_rows(x: jax.Array, k: int) -> jax.Array:
    """Indices [Q, k] of the k largest rows of [R, Q] ``x`` per column,
    ties to the smaller index (``lax.top_k``'s rule), by a stable sort
    along axis 0. On an H100, ``lax.top_k`` over the transpose of the
    fused kernel's output returned wrong elements at k ≤ 16 (XLA's
    dedicated small-k kernel); sorting along the stored axis avoids
    both the transpose and that kernel."""
    return jnp.argsort(-x, axis=0, stable=True)[:k].T


def topk_buckets_nbq(bucket_max_nbq: jax.Array, kp: int) -> jax.Array:
    """topk_buckets on the kernel's NATURAL [nb, Q] layout.

    The fused phase-1 kernel emits bucket maxima as [nb, Q]; selecting
    straight off that layout skips the 128 MB [nb, Q] → [Q, nb]
    transpose (at Q=1024, N=1M) that the [Q, nb] API would force XLA to
    materialize, with identical selected sets. Same coverage + stable-tie argument as
    topk_buckets (groups gathered ascending; ties → smallest bucket)."""
    nb, q = bucket_max_nbq.shape
    if kp > _SEL_GROUP or nb < 8 * _SEL_GROUP or nb <= 2 * kp * _SEL_GROUP:
        return _top_rows(bucket_max_nbq, kp)

    pad = (-nb) % _SEL_GROUP
    if pad:
        bucket_max_nbq = jnp.concatenate(
            [bucket_max_nbq, jnp.full((pad, q), NEG_INF, bucket_max_nbq.dtype)]
        )
    g = bucket_max_nbq.shape[0] // _SEL_GROUP
    grouped = bucket_max_nbq.reshape(g, _SEL_GROUP, q)
    gmax = grouped.max(axis=1)  # [g, Q]

    kg = min(kp, g)
    gidx = _top_rows(gmax, kg)  # [Q, kg], stable
    gidx = jnp.sort(gidx, axis=-1)  # ascending → candidate order = id order

    cand = jnp.take_along_axis(
        grouped.transpose(2, 0, 1), gidx[:, :, None], axis=1
    )  # [Q, kg, 128] — XLA lowers this to a gather; the full transpose
    # never materializes (only kg·128 columns per query are read)
    cand = cand.reshape(q, kg * _SEL_GROUP)
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, 1, _SEL_GROUP), 2)
    cand_ids = (gidx[:, :, None] * _SEL_GROUP + lane).reshape(q, kg * _SEL_GROUP)

    _, pos = jax.lax.top_k(cand, kp)
    bidx = jnp.take_along_axis(cand_ids, pos, axis=1)
    return jnp.minimum(bidx, nb - 1)


def topk_values_ids(s: jax.Array, ids: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """Exact top-k (values, ids) along the last axis, hierarchical.

    Same group-max preselect as topk_buckets but carrying explicit ids —
    for wide candidate rows (IVF rescore can see 32k+ candidates per
    query, where a flat sort-like ``lax.top_k`` dominates the query)."""
    c, w = s.shape
    if w <= 4 * _SEL_GROUP or k > _SEL_GROUP:
        top_s, pos = jax.lax.top_k(s, min(k, w))
        return top_s, jnp.take_along_axis(ids, pos, axis=1)

    pad = (-w) % _SEL_GROUP
    if pad:
        s = jnp.concatenate([s, jnp.full((c, pad), NEG_INF, s.dtype)], axis=1)
        ids = jnp.concatenate([ids, jnp.full((c, pad), -1, ids.dtype)], axis=1)
    g = s.shape[1] // _SEL_GROUP
    grouped = s.reshape(c, g, _SEL_GROUP)
    grouped_ids = ids.reshape(c, g, _SEL_GROUP)
    gmax = grouped.max(axis=-1)

    kg = min(k, g)
    _, gidx = jax.lax.top_k(gmax, kg)
    gidx = jnp.sort(gidx, axis=-1)  # ascending → stable ties by position

    cand = jnp.take_along_axis(grouped, gidx[:, :, None], axis=1).reshape(c, kg * _SEL_GROUP)
    cand_ids = jnp.take_along_axis(grouped_ids, gidx[:, :, None], axis=1).reshape(
        c, kg * _SEL_GROUP
    )
    top_s, pos = jax.lax.top_k(cand, min(k, kg * _SEL_GROUP))
    return top_s, jnp.take_along_axis(cand_ids, pos, axis=1)


def topk_values_min_id(s: jax.Array, ids: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """Exact top-k by (score desc, id asc) — the engine's full tie
    contract, independent of candidate order.

    ``lax.top_k`` breaks ties by POSITION; in the clustered IVF layout
    position order is (cell, row), so cross-cell score ties would
    resolve to the smaller cell instead of the smaller row id. Iterated
    max+min-id (k small) enforces the id rule exactly: each step takes
    the max score, then the smallest id among rows tying at it."""
    big = jnp.int32(2**31 - 1)

    def body(carry, _):
        s_cur = carry
        m = jnp.max(s_cur, axis=1)  # [C]
        tie = s_cur == m[:, None]
        sel = jnp.min(jnp.where(tie & (ids >= 0), ids, big), axis=1)
        hit = tie & (ids == sel[:, None])
        return jnp.where(hit, NEG_INF, s_cur), (m, sel)

    _, (vals, sids) = jax.lax.scan(body, s, None, length=k)
    return vals.T, jnp.where(sids == big, -1, sids).T  # [C, k]


def bucket_for(q: int, n: int) -> int:
    """Rescore-bucket granularity for a (query count, corpus) pair —
    shared by the kernels and host-side IVF bucket-list builders."""
    bucket = BUCKET if q <= _BUCKET_SWITCH_Q else BUCKET_LARGE_Q
    while n % bucket != 0:
        bucket //= 2
    return bucket


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def topk_ivf_clustered(
    corpus_s: jax.Array,  # [N_pad, D] rows SORTED by cell id
    queries: jax.Array,  # [Q, D]
    aux_mul_s: jax.Array,  # [N_pad] (sorted order)
    aux_add_s: jax.Array,  # [N_pad] (sorted order; −inf on masked/pad)
    coded_s: jax.Array,  # [N_pad] int32 cell ids, sorted (−1 pad)
    orig_ids_s: jax.Array,  # [N_pad] int32 original row id per position (−1 pad)
    cells: jax.Array,  # [Q, P] int32 probe cells per query
    bucket_lists: jax.Array,  # [Q, B] int32 bucket indices (−1 pad)
    k: int,
    metric: str,
) -> tuple[jax.Array, jax.Array]:
    """Probed top-k over an IVF-CLUSTERED layout: no corpus scan at all.

    With rows sorted by cell id, a query's probed cells occupy ≤P
    contiguous row ranges; ``bucket_lists`` names the buckets covering
    them (host-computed from the cell offset table). The kernel gathers
    ONLY those buckets and rescores exactly — cost ∝ probed rows, not
    corpus rows. The masked-scan path (topk_two_phase_probed) costs a
    full corpus pass regardless of selectivity — the clustered gather
    is the actual IVF speedup. Boundary buckets contain neighbor cells'
    rows; the per-row probe-membership compare masks them (reference
    index.py:113-126 semantics). Returned ids are ORIGINAL row ids,
    ordered by (distance asc, id asc) — ties resolve by smallest id via
    topk_values_min_id, matching the masked-scan path exactly."""
    metric = canonical_metric(metric)
    n, d = corpus_s.shape
    q = queries.shape[0]
    bucket = bucket_for(q, n)
    n_buckets = n // bucket

    queries_p = prepare_queries(queries, metric)
    kp = bucket_lists.shape[1]
    bucket_ok = bucket_lists >= 0
    bidx = jnp.where(bucket_ok, bucket_lists, 0)

    rows = corpus_s.reshape(n_buckets, bucket, d)
    mul_b = aux_mul_s.reshape(n_buckets, bucket)
    add_b = aux_add_s.reshape(n_buckets, bucket)
    coded_b = coded_s.reshape(n_buckets, bucket)
    oid_b = orig_ids_s.reshape(n_buckets, bucket)
    kk = min(k, kp * bucket)

    def rescore_chunk(args):
        qp_c, bidx_c, ok_c, cells_c = args
        cand_v = rows[bidx_c]  # [C, kp, bucket, D]
        s = jnp.einsum(
            "qd,qkbd->qkb",
            qp_c,
            cand_v,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        s = s * mul_b[bidx_c] + add_b[bidx_c]
        probe_ok = (coded_b[bidx_c][:, :, :, None] == cells_c[:, None, None, :]).any(-1)
        s = jnp.where(probe_ok & ok_c[:, :, None], s, NEG_INF)
        c = qp_c.shape[0]
        s = s.reshape(c, kp * bucket)
        ids = oid_b[bidx_c].reshape(c, kp * bucket)
        return topk_values_min_id(s, ids, kk)

    per_query = kp * bucket * d * 4
    chunk = min(q, max(8, _RESCORE_GATHER_CAP // per_query))
    pad_rows = (-q) % chunk
    if pad_rows:
        queries_p2 = jnp.concatenate([queries_p, jnp.zeros((pad_rows, d), queries_p.dtype)])
        bidx2 = jnp.concatenate([bidx, jnp.zeros((pad_rows, kp), bidx.dtype)])
        ok2 = jnp.concatenate([bucket_ok, jnp.zeros((pad_rows, kp), bool)])
        cells2 = jnp.concatenate(
            [cells, jnp.full((pad_rows, cells.shape[1]), -1, cells.dtype)]
        )
    else:
        queries_p2, bidx2, ok2, cells2 = queries_p, bidx, bucket_ok, cells

    nc = queries_p2.shape[0] // chunk
    top_s, top_ids = jax.lax.map(
        rescore_chunk,
        (
            queries_p2.reshape(nc, chunk, d),
            bidx2.reshape(nc, chunk, kp),
            ok2.reshape(nc, chunk, kp),
            cells2.reshape(nc, chunk, cells.shape[1]),
        ),
    )
    top_s = top_s.reshape(nc * chunk, kk)[:q]
    top_ids = top_ids.reshape(nc * chunk, kk)[:q]

    if kk < k:
        pad = k - kk
        top_s = jnp.concatenate([top_s, jnp.full((q, pad), NEG_INF)], axis=1)
        top_ids = jnp.concatenate([top_ids, jnp.full((q, pad), -1, jnp.int32)], axis=1)

    dist = scores_to_distances(top_s, queries, metric)
    dist = jnp.where(top_s == NEG_INF, jnp.inf, dist)
    top_ids = jnp.where(top_s == NEG_INF, -1, top_ids)
    return dist, top_ids


@functools.partial(jax.jit, static_argnames=("k", "metric", "block_rows"))
def topk_two_phase_probed(
    corpus: jax.Array,  # [N_pad, D]
    queries: jax.Array,  # [Q, D]
    aux_mul: jax.Array,
    aux_add: jax.Array,
    coded: jax.Array,  # [N_pad] int32 (−1 on padding)
    cells: jax.Array,  # [Q, P] int32 probe cells per query
    k: int,
    metric: str,
    block_rows: int | None = None,
    corpus_scan: jax.Array | None = None,
    corpus_scan_int8: tuple[jax.Array, jax.Array] | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Probed (IVF) exact-within-probes top-k, two-phase.

    Same scan-precision contract as :func:`topk_two_phase`: an optional
    bf16 ``corpus_scan`` or int8 ``corpus_scan_int8=(v8, sv)`` feeds
    phase 1 (half/quarter HBM scan traffic); phase 2 always rescores
    against the fp32 ``corpus``, so distances stay exact — only bucket
    selection sees quantization (int8 doubles the candidate margin)."""
    metric = canonical_metric(metric)
    n, d = corpus.shape
    q = queries.shape[0]
    bucket = BUCKET if q <= _BUCKET_SWITCH_Q else BUCKET_LARGE_Q
    while n % bucket != 0:  # tiny shards (sharded search) may not tile
        bucket //= 2
    n_buckets = n // bucket

    queries_p = prepare_queries(queries, metric)
    if corpus_scan_int8 is not None:
        v8, sv = corpus_scan_int8
        q8, inv_sq = quantize_queries_int8(queries_p)
        bucket_max = bucket_scores_scan_probed(
            q8, v8, aux_mul * sv, aux_add, coded, cells, block_rows, bucket,
            inv_sq=inv_sq,
        )
    elif corpus_scan is not None:
        bucket_max = bucket_scores_scan_probed(
            queries_p.astype(corpus_scan.dtype), corpus_scan, aux_mul, aux_add,
            coded, cells, block_rows, bucket,
        )
    else:
        bucket_max = bucket_scores_scan_probed(
            queries_p, corpus, aux_mul, aux_add, coded, cells, block_rows, bucket
        )

    pad = BUCKET_PAD * 2 if corpus_scan_int8 is not None else BUCKET_PAD
    kp = min(k + pad, n_buckets)
    bidx = topk_buckets(bucket_max, kp)
    bidx = jnp.sort(bidx, axis=-1)

    rows = corpus.reshape(n_buckets, bucket, d)
    mul_b = aux_mul.reshape(n_buckets, bucket)
    add_b = aux_add.reshape(n_buckets, bucket)
    coded_b = coded.reshape(n_buckets, bucket)
    kk = min(k, kp * bucket)
    lane_iota = jnp.arange(bucket, dtype=jnp.int32)[None, None, :]

    def rescore_chunk(args):
        qp_c, bidx_c, cells_c = args
        cand_v = rows[bidx_c]
        s = jnp.einsum(
            "qd,qkbd->qkb",
            qp_c,
            cand_v,
            preferred_element_type=jnp.float32,
            # fp32-true rescore: the default precision runs f32 in TF32
            # on the GPU; flops here are negligible vs the gather
            precision=jax.lax.Precision.HIGHEST,
        )
        s = s * mul_b[bidx_c] + add_b[bidx_c]
        probe_ok = (coded_b[bidx_c][:, :, :, None] == cells_c[:, None, None, :]).any(-1)
        s = jnp.where(probe_ok, s, NEG_INF)
        c = qp_c.shape[0]
        s = s.reshape(c, kp * bucket)
        ids = (bidx_c[:, :, None] * bucket + lane_iota).reshape(c, kp * bucket)
        top_s, pos = jax.lax.top_k(s, kk)
        return top_s, jnp.take_along_axis(ids, pos, axis=1)

    per_query = kp * bucket * d * 4
    chunk = min(q, max(64, _RESCORE_GATHER_CAP // per_query))
    pad_rows = (-q) % chunk
    if pad_rows:
        queries_p2 = jnp.concatenate([queries_p, jnp.zeros((pad_rows, d), queries_p.dtype)])
        bidx2 = jnp.concatenate([bidx, jnp.zeros((pad_rows, kp), bidx.dtype)])
        cells2 = jnp.concatenate(
            [cells, jnp.full((pad_rows, cells.shape[1]), -1, cells.dtype)]
        )
    else:
        queries_p2, bidx2, cells2 = queries_p, bidx, cells

    nc = queries_p2.shape[0] // chunk
    top_s, top_ids = jax.lax.map(
        rescore_chunk,
        (
            queries_p2.reshape(nc, chunk, d),
            bidx2.reshape(nc, chunk, kp),
            cells2.reshape(nc, chunk, cells.shape[1]),
        ),
    )
    top_s = top_s.reshape(nc * chunk, kk)[:q]
    top_ids = top_ids.reshape(nc * chunk, kk)[:q]

    if kk < k:
        pad = k - kk
        top_s = jnp.concatenate([top_s, jnp.full((q, pad), NEG_INF)], axis=1)
        top_ids = jnp.concatenate([top_ids, jnp.full((q, pad), -1, jnp.int32)], axis=1)

    dist = scores_to_distances(top_s, queries, metric)
    dist = jnp.where(top_s == NEG_INF, jnp.inf, dist)
    top_ids = jnp.where(top_s == NEG_INF, -1, top_ids)
    return dist, top_ids


# -- phase 2: gather + exact rescore --------------------------------------


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def topk_two_phase(
    corpus: jax.Array,  # [N_pad, D]
    queries: jax.Array,  # [Q, D]
    aux_mul: jax.Array,  # [N_pad]
    aux_add: jax.Array,  # [N_pad]  (−inf on masked/padding rows)
    k: int,
    metric: str,
    corpus_scan: jax.Array | None = None,
    corpus_scan_int8: tuple[jax.Array, jax.Array] | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Exact top-k: (distances [Q, k], row ids [Q, k]; +inf / −1 padding).

    ``corpus_scan`` optionally substitutes a lower-precision (bf16)
    copy for phase 1 — half the HBM scan traffic. ``corpus_scan_int8``
    is a ``(v8, sv)`` pair from :func:`quantize_corpus_int8` — quarter
    traffic, int8 dot. Phase 2 always rescores candidates against
    the fp32 ``corpus``, so returned distances stay exact fp32; only
    bucket *selection* becomes approximate (recall ≈ 1 with the
    BUCKET_PAD margin; opt-in via the executor's ``precision`` knob)."""
    metric = canonical_metric(metric)
    n, d = corpus.shape
    q = queries.shape[0]

    bucket = BUCKET if q <= _BUCKET_SWITCH_Q else BUCKET_LARGE_Q
    while n % bucket != 0:  # tiny shards (sharded search) may not tile
        bucket //= 2
    n_buckets = n // bucket

    queries_p = prepare_queries(queries, metric)

    # int8 selection error exceeds bf16's — widen the candidate margin
    pad = BUCKET_PAD * 2 if corpus_scan_int8 is not None else BUCKET_PAD
    kp = min(k + pad, n_buckets)

    if corpus_scan_int8 is not None:
        v8, sv = corpus_scan_int8
        q8, inv_sq = quantize_queries_int8(queries_p)
        ams = aux_mul * sv
        if q > ONESHOT_MAX_Q and _bigq_eligible(n):
            # kernel-natural [nb, Q] maxima + transpose-free selection
            bm_nbq = bucket_scores_triton(
                q8, v8, ams, aux_add, inv_sq=inv_sq, bucket=bucket
            )
            bidx = topk_buckets_nbq(bm_nbq, kp)
        else:
            bucket_max = bucket_scores_scan_int8(q8, v8, ams, aux_add, inv_sq, bucket)
            bidx = topk_buckets(bucket_max, kp)
    else:
        scan_c = corpus if corpus_scan is None else corpus_scan
        scan_q = queries_p if corpus_scan is None else queries_p.astype(corpus_scan.dtype)
        acc_bytes = 2 if scan_c.dtype == jnp.bfloat16 else 4
        oneshot = q <= ONESHOT_MAX_Q and n * q * acc_bytes <= ONESHOT_INTERMEDIATE_CAP
        if not oneshot and _bigq_eligible(n):
            bm_nbq = bucket_scores_triton(
                scan_q, scan_c, aux_mul, aux_add, bucket=bucket
            )
            bidx = topk_buckets_nbq(bm_nbq, kp)
        else:
            bucket_max = bucket_scores_scan(scan_q, scan_c, aux_mul, aux_add, bucket)
            bidx = topk_buckets(bucket_max, kp)

    # gather in ascending bucket order so final ties resolve to smallest id
    bidx = jnp.sort(bidx, axis=-1)  # stable ties above → smallest bucket id

    rows = corpus.reshape(n_buckets, bucket, d)
    mul_b = aux_mul.reshape(n_buckets, bucket)
    add_b = aux_add.reshape(n_buckets, bucket)
    kk = min(k, kp * bucket)
    lane_iota = jnp.arange(bucket, dtype=jnp.int32)[None, None, :]

    def rescore_chunk(args):
        """Gather + exact rescore for one query chunk (bounds the device
        memory footprint of the [chunk, kp, bucket, D] candidate gather)."""
        qp_c, bidx_c = args  # [C, D], [C, kp]
        cand_v = rows[bidx_c]  # [C, kp, bucket, D]
        s = jnp.einsum(
            "qd,qkbd->qkb",
            qp_c,
            cand_v,
            preferred_element_type=jnp.float32,
            # fp32-true rescore: the default precision runs f32 in TF32
            # on the GPU; flops here are negligible vs the gather
            precision=jax.lax.Precision.HIGHEST,
        )
        s = s * mul_b[bidx_c] + add_b[bidx_c]
        c = qp_c.shape[0]
        s = s.reshape(c, kp * bucket)
        ids = (bidx_c[:, :, None] * bucket + lane_iota).reshape(c, kp * bucket)
        top_s, pos = jax.lax.top_k(s, kk)
        return top_s, jnp.take_along_axis(ids, pos, axis=1)

    # Chunk only when the [Q, kp, bucket, D] gather would exceed the
    # staging budget — lax.map serializes its steps.
    per_query = kp * bucket * d * 4
    chunk = min(q, max(64, _RESCORE_GATHER_CAP // per_query))
    if q % chunk != 0:
        pad_rows = (-q) % chunk
        queries_p2 = jnp.concatenate([queries_p, jnp.zeros((pad_rows, d), queries_p.dtype)])
        bidx2 = jnp.concatenate([bidx, jnp.zeros((pad_rows, kp), bidx.dtype)])
    else:
        pad_rows = 0
        queries_p2, bidx2 = queries_p, bidx

    nc = queries_p2.shape[0] // chunk
    top_s, top_ids = jax.lax.map(
        rescore_chunk,
        (queries_p2.reshape(nc, chunk, d), bidx2.reshape(nc, chunk, kp)),
    )
    top_s = top_s.reshape(nc * chunk, kk)[:q]
    top_ids = top_ids.reshape(nc * chunk, kk)[:q]

    if kk < k:  # pad to k
        pad = k - kk
        top_s = jnp.concatenate([top_s, jnp.full((q, pad), NEG_INF)], axis=1)
        top_ids = jnp.concatenate([top_ids, jnp.full((q, pad), -1, jnp.int32)], axis=1)

    dist = scores_to_distances(top_s, queries, metric)
    dist = jnp.where(top_s == NEG_INF, jnp.inf, dist)
    top_ids = jnp.where(top_s == NEG_INF, -1, top_ids)
    return dist, top_ids


@functools.partial(jax.jit, static_argnames=("k", "w", "metric"))
def topk_window_int8(
    v8: jax.Array,  # [N_pad, D] int8 scan copy
    sv: jax.Array,  # [N_pad] f32 per-row quantization scale
    queries: jax.Array,  # [Q, D] fp32
    aux_mul: jax.Array,  # [N_pad] f32
    aux_add: jax.Array,  # [N_pad] f32 (−inf on masked/padding rows)
    k: int,
    w: int,
    metric: str,
) -> jax.Array:  # [Q, W] int32 global row ids
    """Phase A of the int8-resident (host-rescore) pipeline: int8 phase-1
    bucket scan → hierarchical selection of ``kp`` candidate buckets →
    NARROWING rescore (fp32 prepared query × dequantized int8 rows, with
    the EXACT per-row aux from the fp32 host corpus) → top-``W`` global
    row ids per query.

    This is the engine form of the composition in
    benchmarks/config2_fullscale.py: the fp32 corpus
    never touches the device — the host gathers the returned window rows
    and rescores exactly (engine/residency.py). The narrowing dot's only
    error is the row-side quantization residual (query side is fp32),
    so the true top-k needs a multi-σ excursion to fall outside a
    W ≫ k window; recall is asserted against a float64 oracle in the
    full-scale benchmark and pinned exact in CPU tests where W ≥ N.

    Returned width is ``min(w, kp·bucket, n)`` — callers read the
    result shape. May include masked/padding rows when fewer than W
    candidates score above −inf; the host rescore re-applies validity.
    """
    metric = canonical_metric(metric)
    n, d = v8.shape
    q = queries.shape[0]

    queries_p = prepare_queries(queries, metric)
    q8, inv_sq = quantize_queries_int8(queries_p)
    ams = aux_mul * sv

    bucket = bucket_for(q, n)
    n_buckets = n // bucket
    # enough buckets to fill the window, plus the int8 selection margin
    kp = min(max(k, -(-w // bucket)) + 2 * BUCKET_PAD, n_buckets)
    ww = min(w, kp * bucket)

    if q > ONESHOT_MAX_Q and _bigq_eligible(n):
        bm_nbq = bucket_scores_triton(
            q8, v8, ams, aux_add, inv_sq=inv_sq, bucket=bucket
        )
        bidx = topk_buckets_nbq(bm_nbq, kp)
    else:
        bucket_max = bucket_scores_scan_int8(q8, v8, ams, aux_add, inv_sq, bucket)
        bidx = topk_buckets(bucket_max, kp)
    bidx = jnp.sort(bidx, axis=-1)  # ascending bucket order (stable ids)

    rows8 = v8.reshape(n_buckets, bucket, d)
    mul_b = ams.reshape(n_buckets, bucket)
    add_b = aux_add.reshape(n_buckets, bucket)
    lane_iota = jnp.arange(bucket, dtype=jnp.int32)[None, None, :]

    def window_chunk(args):
        qp_c, bidx_c = args  # [C, D], [C, kp]
        cand8 = rows8[bidx_c]  # [C, kp, bucket, D] int8
        # narrowing score: fp32 query × dequantized row + exact aux —
        # the row scale folds into mul_b, the exact −‖v‖² rides add_b.
        # Default precision: TF32 on the GPU. The window is W ≫ k and
        # the host rescores it exactly, so selection error here only
        # needs to stay inside the window.
        s = jnp.einsum(
            "qd,qkbd->qkb",
            qp_c,
            cand8.astype(jnp.float32),
            preferred_element_type=jnp.float32,
        )
        s = s * mul_b[bidx_c] + add_b[bidx_c]
        c = qp_c.shape[0]
        s = s.reshape(c, kp * bucket)
        ids = (bidx_c[:, :, None] * bucket + lane_iota).reshape(c, kp * bucket)
        _, pos = jax.lax.top_k(s, ww)
        return jnp.take_along_axis(ids, pos, axis=1)

    per_query = kp * bucket * d * 4
    chunk = min(q, max(8, _RESCORE_GATHER_CAP // per_query))
    pad_rows = (-q) % chunk
    if pad_rows:
        queries_p2 = jnp.concatenate(
            [queries_p, jnp.zeros((pad_rows, d), queries_p.dtype)]
        )
        bidx2 = jnp.concatenate([bidx, jnp.zeros((pad_rows, kp), bidx.dtype)])
    else:
        queries_p2, bidx2 = queries_p, bidx

    nc = queries_p2.shape[0] // chunk
    win = jax.lax.map(
        window_chunk,
        (queries_p2.reshape(nc, chunk, d), bidx2.reshape(nc, chunk, kp)),
    )
    return win.reshape(nc * chunk, ww)[:q]
