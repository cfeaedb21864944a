"""Device-resident column cache.

The reference memory-maps Arrow files per request and hands full columns
to torch (/root/reference/src/fenix/io/index/index.py:93-97, 161-168).
On the accelerator the analog is a cache of HBM-resident padded column blocks keyed
by (source, column): the first query against a table pays the host→HBM
transfer; subsequent queries run entirely out of HBM. Tables are
immutable artifacts (rewritten atomically on ingest), so cache entries
are invalidated by file mtime.
"""

from __future__ import annotations

import functools
import itertools
import os
import threading
from collections import OrderedDict
from typing import Sequence

import numpy as np
import pyarrow as pa

from fenix_tpu import coder as coder_mod
from fenix_tpu.io import arrow, ingest, table
from fenix_tpu.utils import hbm

# Row-block granularity for padded device columns: every corpus pads to
# a multiple of it, so power-of-two scan blocks and the fused kernel's
# 128-row blocks always divide. Chosen on the previous accelerator;
# unmeasured on the H100 (ROADMAP S2).
DEFAULT_BLOCK = 16384


def _source_key(source: str | Sequence[str]) -> tuple[str, ...]:
    return (source,) if isinstance(source, str) else tuple(source)


def _require_int32(host: np.ndarray, column: str) -> np.ndarray:
    """int64 host columns must fit the device's int32 lanes (jax x64 is
    off). Guard loudly instead of silently wrapping (aliased join keys /
    group ids); non-int64 columns pass through untouched."""
    if host.dtype == np.int64 and host.size:
        if host.max(initial=0) > np.iinfo(np.int32).max or host.min(
            initial=0
        ) < np.iinfo(np.int32).min:
            raise ValueError(
                f"column {column!r} has int64 values outside the "
                "device int32 range; re-key the table below 2^31"
            )
        return host.astype(np.int32)
    return host


def _grow_jit(old, delta, start, new_pad: int):
    import jax
    import jax.numpy as jnp

    buf = (
        old
        if new_pad == old.shape[0]
        else jnp.zeros((new_pad, old.shape[1]), old.dtype).at[: old.shape[0]].set(old)
    )
    return jax.lax.dynamic_update_slice(buf, delta, (start, 0))


_GROW_COMPILED = None
_GROW_INIT_LOCK = threading.Lock()

_INT8_UPLOAD = None


def _int8_upload_fn():
    """Donated chunk writer for the int8-solo upload: the int8 buffer
    is the ONLY corpus-sized device allocation alive during the build
    (donation reuses it across chunk writes). jit'd once lazily."""
    global _INT8_UPLOAD
    if _INT8_UPLOAD is None:
        import jax

        with _GROW_INIT_LOCK:
            if _INT8_UPLOAD is None:
                _INT8_UPLOAD = jax.jit(
                    lambda buf, c, s: jax.lax.dynamic_update_slice(buf, c, (s, 0)),
                    donate_argnums=0,
                )
    return _INT8_UPLOAD

def _sweep_dead_tmp(cdir: str) -> None:
    """Remove sidecar ``.tmp-<pid>-*`` orphans left by KILLED writers
    (their exception handlers never ran). ONLY dead writers' files: the
    names embed the writer pid, and deleting a LIVE concurrent writer's
    tmp files (two servers cold-starting on one --root) makes its
    os.replace raise and its handler rmtree the whole cdir — destroying
    the winner's just-built sidecar (round-4 advisor)."""
    import glob
    import re

    for orphan in glob.glob(os.path.join(glob.escape(cdir), ".tmp-*")) + glob.glob(
        os.path.join(glob.escape(cdir), "*.tmp-*")
    ):
        m = re.search(r"\.tmp-(\d+)", os.path.basename(orphan))
        if m and int(m.group(1)) != os.getpid():
            try:
                os.kill(int(m.group(1)), 0)
                continue  # writer alive: leave its files
            except ProcessLookupError:
                pass  # dead: sweep
            except OSError:
                continue  # EPERM etc: assume alive
        try:
            os.unlink(orphan)
        except OSError:
            pass


def _quantize_chunk_rows(dim: int, target_bytes: int = 256 << 20) -> int:
    """Rows per host-quantize slice, sized by BYTES not rows: each
    quantize call materializes fp32 temporaries ~3× its slice, so a
    fixed 1M-row chunk is ~20 GB of transient RAM at d=1536 on the
    2-core host (round-4 advisor). ~256 MB slices keep them <1 GB."""
    return max(1, target_bytes // (4 * dim))


# inverse of json.dumps(self._mtimes(key)) — shared with io/table.py so
# the stamp wire form has exactly one parser (round-5 review)
_parse_stamp_json = table.stamps_from_json


def _npy_append_rows(path: str, arr: np.ndarray, expect_rows: int) -> bool:
    """Append ``arr``'s rows to a ``.npy`` file IN PLACE, rewriting the
    header shape — the O(delta)-disk half of the incremental host-mirror
    refresh (VERDICT r4 next #4). Returns False (file untouched) when
    the on-disk shape isn't ``expect_rows`` (a concurrent writer won),
    the dtype/inner-shape mismatch, or the grown shape string wouldn't
    fit the existing fixed-size header — callers fall back to a full
    rewrite. Crash-safe with the sidecar's meta-last protocol: data
    bytes append BEFORE the header grows, so a torn write leaves a
    parseable old-shape file (and no meta → readers rebuild)."""
    import io as io_mod

    from numpy.lib import format as npf

    with open(path, "r+b") as fh:
        version = npf.read_magic(fh)
        # public per-version readers only — the private _read_array_header
        # changes signature across numpy releases (round-5 review)
        if version == (1, 0):
            shape, fortran, dtype = npf.read_array_header_1_0(fh)
        elif version == (2, 0):
            shape, fortran, dtype = npf.read_array_header_2_0(fh)
        else:
            return False
        hdr_end = fh.tell()
        if (
            fortran
            or dtype != arr.dtype
            or shape[1:] != arr.shape[1:]
            or shape[0] != expect_rows
        ):
            return False
        buf = io_mod.BytesIO()
        try:
            npf.write_array_header_1_0(
                buf,
                {
                    "descr": npf.dtype_to_descr(dtype),
                    "fortran_order": False,
                    "shape": (shape[0] + arr.shape[0],) + shape[1:],
                },
            )
        except Exception:
            return False
        hdr = buf.getvalue()
        if len(hdr) != hdr_end:
            return False  # shape digits crossed the header padding
        fh.seek(0, 2)
        fh.write(np.ascontiguousarray(arr).tobytes())
        fh.seek(0)
        fh.write(hdr)
        fh.flush()
        os.fsync(fh.fileno())
    return True


# device masks memoize per full predicate (literals included); bound the
# cache — parametric per-query literals would otherwise grow it forever
_MASK_CACHE_LIMIT = 128


@functools.lru_cache(maxsize=256)
def _mask_eval_fn(skeleton_json: str):
    """Compiled device evaluation for a predicate SKELETON (literals
    slotted out by expr.split_literals): one jit serves every literal
    value of a parametric predicate."""
    import jax

    from fenix_tpu import expr as expr_mod

    skel = expr_mod.Expr.from_json(skeleton_json)
    fields = tuple(sorted(skel.fields()))

    @jax.jit
    def fn(columns, slots):
        return skel.device_mask(dict(zip(fields, columns)), slots)

    return fn, fields


@functools.lru_cache(maxsize=None)
def _sharded_grow_fn(sharding):
    """Mesh twin of :func:`_grow_jit`: extend a ROW-SHARDED device
    matrix and write the delta into its tail. The capacity extension
    (when the append outgrows the padding) moves existing rows between
    shards over the interconnect — the host uploads only the delta.
    Memoized per sharding so repeated appends reuse one compiled fn."""
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("new_pad",))
    def f(old, delta, start, new_pad: int):
        extra = new_pad - old.shape[0]
        buf = (
            old
            if extra == 0
            else jnp.concatenate(
                [old, jnp.zeros((extra, old.shape[1]), old.dtype)]
            )
        )
        buf = jax.lax.with_sharding_constraint(buf, sharding)
        out = jax.lax.dynamic_update_slice(buf, delta, (start, 0))
        return jax.lax.with_sharding_constraint(out, sharding)

    return f


@functools.lru_cache(maxsize=None)
def _sharded_valid_fn(sharding):
    """Row-sharded validity mask computed ON DEVICE (iota < rows) — a
    cold build or append refresh transfers zero mask bytes."""
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("n_pad",))
    def f(rows, n_pad: int):
        v = jnp.arange(n_pad, dtype=jnp.int32) < rows
        return jax.lax.with_sharding_constraint(v, sharding)

    return f


@functools.lru_cache(maxsize=None)
def _compact_fn(sharding):
    """Device-side row compaction for delete-lineage refreshes: gather
    the kept rows by a replicated ``[new_pad]`` int32 index and zero the
    padding tail. With a sharding, the output re-places contiguously
    across shards (the gather moves rows over the interconnect). No
    donation — in-flight searches may still hold the old array."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def f(old, idx, rows):
        take = jnp.take(old, idx, axis=0)
        valid = (jnp.arange(idx.shape[0], dtype=jnp.int32) < rows)[:, None]
        out = jnp.where(valid, take, jnp.zeros((), old.dtype))
        if sharding is not None:
            out = jax.lax.with_sharding_constraint(out, sharding)
        return out

    return f


def _grow_update(old, delta, old_rows: int, new_pad: int):
    """On-device buffer extension (ONE module-level jit keyed by the
    quantized shapes; no donation — in-flight searches may still hold
    the old array)."""
    import jax
    import jax.numpy as jnp

    global _GROW_COMPILED
    if _GROW_COMPILED is None:  # jax imports lazily in this module
        with _GROW_INIT_LOCK:
            if _GROW_COMPILED is None:
                _GROW_COMPILED = jax.jit(_grow_jit, static_argnames=("new_pad",))
    return _GROW_COMPILED(old, delta, jnp.int32(old_rows), new_pad=new_pad)


_GROW1_COMPILED = None


def _grow1_update(old, delta, old_rows: int, new_pad: int, fill: float):
    """1-D sibling of :func:`_grow_update` (per-row scale vectors);
    capacity extensions fill the tail with ``fill`` so padding rows
    keep their sentinel value."""
    import jax
    import jax.numpy as jnp

    global _GROW1_COMPILED
    if _GROW1_COMPILED is None:
        with _GROW_INIT_LOCK:
            if _GROW1_COMPILED is None:

                def g(old, delta, start, new_pad: int, fill: float):
                    buf = (
                        old
                        if new_pad == old.shape[0]
                        else jnp.full((new_pad,), fill, old.dtype)
                        .at[: old.shape[0]]
                        .set(old)
                    )
                    return jax.lax.dynamic_update_slice(buf, delta, (start,))

                _GROW1_COMPILED = jax.jit(g, static_argnames=("new_pad", "fill"))
    return _GROW1_COMPILED(old, delta, jnp.int32(old_rows), new_pad=new_pad, fill=fill)


class DeviceCache:
    """Per-root cache of host tables and device-resident columns."""

    def __init__(
        self, root: str, block: int = DEFAULT_BLOCK, mesh="auto"
    ) -> None:
        self.root = root
        self.block = block
        # "auto" resolves lazily on first use: parallel.mesh.serving_mesh()
        # touches jax.devices(), which initializes the backend — the
        # cache itself must stay cheap to construct.
        self._mesh = mesh
        self._host: dict = {}
        self._device: dict = {}
        # count of append-only refreshes served by the incremental
        # device-buffer extension (observability + tests)
        self.incremental_refreshes: int = 0
        # count of delete/compaction refreshes served by the keep-mask
        # lineage (device-side gather; no corpus re-stream)
        self.lineage_refreshes: int = 0
        # pushdown observability: device-mask builds (cold evaluations;
        # cache hits transfer nothing) — tests assert zero per-query
        # host mask uploads through these
        self.device_mask_builds: int = 0
        # clustered-layout (IVF) device rebuilds — corpus-sized gathers;
        # tests pin that a fixed revision never rebuilds twice (the r2
        # eviction bug deleted same-revision layouts mid-request)
        self.clustered_builds: int = 0
        self._masks: OrderedDict = OrderedDict()
        # The Flight server dispatches handlers from a thread pool; a
        # single lock serializes cache fills (first query per column) —
        # steady-state hits only read the dicts.
        self._lock = threading.RLock()
        # capacity-aware eviction (FENIX_HBM_BUDGET bytes, 0 = off):
        # recency stamp per entry + eviction count. The stamp source is
        # itertools.count (atomic under the GIL) because _touch runs on
        # the LOCK-FREE memo fast path — a plain `self._n += 1` would
        # lose increments across concurrent readers and skew the LRU
        # order (a hot entry could look cold and be evicted).
        self._recency: dict = {}
        self._access = itertools.count(1)
        self.evictions: int = 0
        # in-flight unlocked builds (ckey -> Event) — see _memo_unlocked
        self._builds: dict = {}

    def _touch(self, ckey) -> None:
        self._recency[ckey] = next(self._access)

    def _maybe_evict(self, keep) -> None:
        """Capacity-aware LRU eviction: when FENIX_HBM_BUDGET (bytes) is
        set and cached device entries exceed it, drop the least recently
        used entries (never the one just built). Usable HBM is the
        binding single-chip limit (~8-9 GB through this environment's
        device — benchmarks/exp_16m.py); without a budget a server
        holding many tables' matrices + scan copies OOMs with no
        recourse. Safe under concurrency: eviction only drops dict
        references — in-flight requests keep the arrays alive."""
        env = os.environ.get("FENIX_HBM_BUDGET", "")
        budget = hbm.parse_budget(env) if env else None  # one parser
        if not budget:  # unset/<=0 = eviction off (device limit never
            return  # drives eviction — only the explicit budget does)
        with self._lock:
            while self.device_bytes() > budget:
                candidates = [k for k in self._device if k != keep]
                if not candidates:
                    return
                victim = min(candidates, key=lambda k: self._recency.get(k, 0))
                del self._device[victim]
                self._recency.pop(victim, None)
                self.evictions += 1

    # -- host tables ------------------------------------------------------

    def _mtimes(self, sources: tuple[str, ...]) -> tuple:
        # revision tokens: base mtime + live delta parts (table.stamp)
        return tuple(table.stamp(self.root, s) for s in sources)

    def _memo(self, store: dict, ckey, stamp, build):
        """Double-checked locked memoization keyed by file mtimes."""
        hit = store.get(ckey)
        if hit is not None and hit[0] == stamp:
            if store is self._device:
                self._touch(ckey)
            return hit[1]
        with self._lock:
            hit = store.get(ckey)
            if hit is not None and hit[0] == stamp:
                if store is self._device:
                    self._touch(ckey)
                return hit[1]
            value = build()
            store[ckey] = (stamp, value)
            if store is self._device:
                self._touch(ckey)
                self._maybe_evict(ckey)
            return value

    def _memo_unlocked(self, store: dict, ckey, stamp, build):
        """Memoization whose BUILD runs outside the global cache lock
        (for host_int8's multi-minute quantize+persist at scale — under
        ``_memo`` it would stall every other cold cache fill on any
        table for its whole duration). One builder per key at a time:
        concurrent callers wait on a per-key event, then re-check the
        memo and rebuild themselves only if the builder failed or built
        a different revision."""
        import threading as threading_mod

        while True:
            hit = store.get(ckey)
            if hit is not None and hit[0] == stamp:
                return hit[1]
            with self._lock:
                hit = store.get(ckey)
                if hit is not None and hit[0] == stamp:
                    return hit[1]
                ev = self._builds.get(ckey)
                if ev is None:
                    ev = self._builds[ckey] = threading_mod.Event()
                    am_builder = True
                else:
                    am_builder = False
            if not am_builder:
                ev.wait()
                continue  # builder published (or failed): re-check
            try:
                value = build()  # NO lock held
                with self._lock:
                    store[ckey] = (stamp, value)
                return value
            finally:
                with self._lock:
                    self._builds.pop(ckey, None)
                ev.set()

    def device_bytes(self) -> int:
        """Total HBM bytes held by cached device entries (deduplicated
        by buffer identity — derived entries may alias). Capacity
        observability: the usable device memory bounds corpus + scan
        copies + clustered layouts — surfaced as ``cache.device_bytes``
        in the Flight stats action."""
        import jax

        total = 0
        seen: set[int] = set()

        def add(x) -> None:
            nonlocal total
            if isinstance(x, ingest.DeviceColumn):
                add(x.data)
            elif isinstance(x, (tuple, list)):
                for y in x:
                    add(y)
            elif isinstance(x, jax.Array) and id(x) not in seen:
                seen.add(id(x))
                total += x.nbytes

        with self._lock:
            for _, value in self._device.values():
                add(value)
        return total

    def host_table(self, source: str | Sequence[str]) -> pa.Table:
        key = _source_key(source)
        stamp = self._mtimes(key)

        def build() -> pa.Table:
            # A newer table revision frees the superseded derived
            # device buffers eagerly (clustered layouts / scan copies
            # can hold corpus-sized HBM; waiting for re-access would
            # leak them for variants never used again) — EXCEPT the
            # fp32 matrix entries (flat AND row-sharded), which the
            # incremental append refresh extends from. Eviction is
            # PER-ENTRY BY STAMP: only entries built against an older
            # revision go; a first-time host load at the current
            # revision (e.g. the pushdown path touching host_table
            # mid-request) must not drop the corpus-sized layouts the
            # same request just built. Mutate in place: concurrent
            # _memo calls hold a reference to this dict.
            for stale in [
                k
                for k, (entry_stamp, _) in self._device.items()
                if k[0] == key
                # Device stamps are the table stamp, optionally extended
                # with coded-index mtimes — prefix-compare against the
                # table stamp (an exact compare would evict every
                # clustered entry on every host load).
                and entry_stamp[: len(stamp)] != stamp
                and not (len(k) == 3 and k[2] in ("matrix", "sharded_matrix"))
            ]:
                del self._device[stale]
            return table.load(self.root, key if len(key) > 1 else key[0])

        return self._memo(self._host, key, stamp, build)

    # -- host-resident corpus (int8-resident / streaming modes) ------------

    def host_matrix(self, source: str | Sequence[str], column: str) -> np.ndarray:
        """Host-resident ``[N, D]`` fp32 view of the vector column —
        the exact-rescore side of the int8-resident serving mode and
        the source of the larger-than-HBM streaming scan (VERDICT r3
        #1/#3). Zero-copy off the Arrow mmap for single-part fp32
        tables; memoized per revision either way."""
        key = _source_key(source)
        stamp = self._mtimes(key)

        def build() -> np.ndarray:
            data = self.host_table(source)
            host = ingest.fixed_size_list_to_numpy(data.column(column))
            return np.ascontiguousarray(host, dtype=np.float32)

        return self._memo(self._host, (key, column, "host_matrix"), stamp, build)

    def host_int8(self, source: str | Sequence[str], column: str):
        """Host-resident int8 mirror ``(codes [N, D] int8, scales [N]
        f32)`` of the vector column, memoized per revision. The
        streaming int8 scan slices pre-quantized chunks out of it per
        request — quantizing the corpus inside every search measured
        minutes per stream at 16M×768 on a 2-core host (round 4), which
        swamped the transfer the int8 mode exists to quarter. Built
        with the shared host quantizer (ops.topk2.quantize_rows_int8_np).

        PERSISTED as a revision-stamped sidecar next to the table
        (io.table.int8cache_dir: codes.npy/scales.npy/meta.json,
        meta written LAST so a crash mid-write reads as absent) —
        a server restart memory-maps the codes instead of re-reading
        and re-quantizing the fp32 corpus (970 s at 16M×768 on this
        host; the mmap load is ~0 and costs no anonymous RAM).

        Mutations refresh INCREMENTALLY (same standard as the device
        caches' _grow_matrix/_shrink_matrix — VERDICT r4 next #4):
        append-only revisions quantize ONLY the appended rows and grow
        the sidecar files in place (O(delta) quantize AND disk I/O);
        delete/compaction hops gather surviving rows from the old
        mirror via the keep-mask lineage (no re-quantize). Only
        revision gaps with no recorded hop pay the full O(N) rebuild.
        Single-source tables only; stale stamps rebuild and replace.
        Counters: cache.int8_sidecar_loads / _writes,
        cache.mirror_delta_refreshes, cache.mirror_rows_quantized."""
        key = _source_key(source)
        stamp = self._mtimes(key)

        def build():
            import json as json_mod

            from fenix_tpu.ops import topk2
            from fenix_tpu.utils.metrics import GLOBAL as metrics

            cdir = self._int8_cdir(key, column)
            stamp_s = json_mod.dumps(stamp)
            meta_path = cdir and os.path.join(cdir, "meta.json")

            loaded = self._read_int8_sidecar(cdir, meta_path, column)
            if loaded is not None and loaded[2].get("stamp") == stamp_s:
                metrics.add("cache.int8_sidecar_loads")
                return loaded[0], loaded[1]

            grown = self._host_int8_incremental(
                key, column, stamp, cdir, meta_path, stamp_s, loaded
            )
            if grown is not None:
                return grown

            host = self.host_matrix(source, column)
            rows, d = host.shape
            codes = np.empty((rows, d), np.int8)
            scales = np.empty(rows, np.float32)
            chunk = _quantize_chunk_rows(d)
            for s in range(0, rows, chunk):
                e = min(s + chunk, rows)
                codes[s:e], scales[s:e] = topk2.quantize_rows_int8_np(host[s:e])
            metrics.add("cache.mirror_rows_quantized", rows)
            return self._write_int8_sidecar(
                cdir, meta_path, codes, scales, stamp_s, column
            )

        return self._memo_unlocked(
            self._host, (key, column, "host_int8"), stamp, build
        )

    def _int8_cdir(self, key: tuple, column: str) -> "str | None":
        if len(key) != 1:
            return None
        import hashlib

        # one subdir per COLUMN: a table with two searchable vector
        # columns must not thrash one shared sidecar (column names are
        # arbitrary strings — hash for the path; meta.json still
        # records the real name)
        return os.path.join(
            table.int8cache_dir(self.root, key[0]),
            hashlib.sha1(column.encode()).hexdigest()[:16],
        )

    def _read_int8_sidecar(self, cdir, meta_path, column: str):
        """``(codes mmap, scales, meta)`` for WHATEVER revision the
        sidecar holds (the stamp check is the caller's — an old-stamp
        sidecar is the base of the incremental refresh), or None."""
        import json as json_mod

        if cdir is None or not os.path.isdir(cdir):
            return None
        try:
            with open(meta_path) as fh:
                meta = json_mod.load(fh)
            if meta.get("column") != column:
                return None
            codes = np.load(os.path.join(cdir, "codes.npy"), mmap_mode="r")
            scales = np.load(os.path.join(cdir, "scales.npy"))
            # re-validate AFTER loading: a concurrent rebuild (another
            # process; this process serializes builds) could have
            # replaced the files between the meta read and the loads —
            # a cross-revision (codes, scales) pair would crash the
            # chunk slicing mid-search. The rows check also rejects a
            # torn in-place append (grown header, stale meta).
            with open(meta_path) as fh:
                if json_mod.load(fh) != meta:
                    return None
            if scales.shape[0] != codes.shape[0] or codes.shape[0] != meta.get(
                "rows"
            ):
                return None
            return codes, scales, meta
        except Exception:
            return None  # corrupt/absent: caller rebuilds

    def _write_int8_sidecar(self, cdir, meta_path, codes, scales, stamp_s, column):
        """Full sidecar (re)write with the crash-safe protocol:
        invalidate meta → data files via tmp+replace → meta LAST.
        Returns the (possibly mmap-reloaded) ``(codes, scales)``."""
        import json as json_mod
        import shutil

        from fenix_tpu.utils.metrics import GLOBAL as metrics

        if cdir is None:
            return codes, scales
        try:
            os.makedirs(cdir, exist_ok=True)
            _sweep_dead_tmp(cdir)
            if os.path.exists(meta_path):
                os.unlink(meta_path)  # invalidate before touching data
            for arr, fname in ((codes, "codes.npy"), (scales, "scales.npy")):
                tmp = os.path.join(cdir, f".tmp-{os.getpid()}-{fname}")
                with open(tmp, "wb") as fh:
                    np.save(fh, np.ascontiguousarray(arr))
                os.replace(tmp, os.path.join(cdir, fname))
            tmp = meta_path + f".tmp-{os.getpid()}"
            with open(tmp, "w") as fh:
                json_mod.dump(
                    {"stamp": stamp_s, "column": column,
                     "rows": int(codes.shape[0]), "dim": int(codes.shape[1])},
                    fh,
                )
            os.replace(tmp, meta_path)
            metrics.add("cache.int8_sidecar_writes")
            # serve the just-written file via mmap: the page-cache-
            # backed mapping is evictable, where the anonymous build
            # array would pin N·D bytes of RAM for the process life
            codes = np.load(os.path.join(cdir, "codes.npy"), mmap_mode="r")
        except OSError:
            # disk full or unwritable root: serve in-memory and leave
            # no half-written cache behind (no meta = no cache as far
            # as readers are concerned)
            shutil.rmtree(cdir, ignore_errors=True)
        return codes, scales

    def _host_int8_incremental(
        self, key, column, stamp, cdir, meta_path, stamp_s, sidecar
    ):
        """O(delta) host-mirror refresh across one recorded table hop
        (VERDICT r4 next #4, the device caches' incremental standard
        applied to the host mirror): append-only revisions quantize
        ONLY the appended rows — and when the sidecar holds the
        previous revision, append them IN PLACE to codes.npy/scales.npy
        (O(delta) disk I/O, _npy_append_rows); delete/compaction hops
        gather surviving rows from the old mirror via the keep-mask
        lineage (no re-quantize; sidecar rewritten without quantizing).
        Returns the refreshed ``(codes, scales)`` or None → full
        rebuild."""
        if len(key) != 1:
            return None
        from fenix_tpu.ops import topk2
        from fenix_tpu.utils.metrics import GLOBAL as metrics

        name = key[0]
        old = self._host.get((key, column, "host_int8"))
        old_stamp = old_codes = old_scales = None
        if old is not None:
            old_stamp = old[0]
            old_codes, old_scales = old[1]
        sidecar_stamp = None
        if sidecar is not None:
            try:
                sidecar_stamp = _parse_stamp_json(sidecar[2]["stamp"])
            except Exception:
                sidecar = None
        if old_codes is None and sidecar is not None:
            old_stamp = sidecar_stamp
            old_codes, old_scales = sidecar[0], sidecar[1]
        if old_codes is None or old_stamp is None:
            return None

        # one recorded hop from the old revision to the current one:
        # pure append, or lineage (delete/compaction) + optional append
        keep = None
        delta_names = table.append_delta(old_stamp[0], stamp[0])
        if delta_names is None:
            lin = table.lineage(self.root, name)
            if lin is None:
                return None
            lin_old, lin_new, keep = lin
            if lin_old != old_stamp[0] or keep.shape[0] != old_codes.shape[0]:
                return None
            delta_names = (
                [] if lin_new == stamp[0] else table.append_delta(lin_new, stamp[0])
            )
            if delta_names is None:
                return None

        dcodes = dscales = None
        if delta_names:
            try:
                parts = table.load_parts(self.root, name, delta_names)
                delta = ingest.fixed_size_list_to_numpy(
                    parts.column(column)
                ).astype(np.float32, copy=False)
            except (FileNotFoundError, KeyError, TypeError):
                return None  # raced mutation / schema drift
            # parts load by NAME: a compaction + fresh append between
            # the stamp read and here can REUSE part file names with
            # different rows (the documented hazard matrix() re-checks
            # mtimes for). A stale read must not be quantized into a
            # sidecar stamped as this revision — persisted wrong rows
            # would not self-heal until the next mutation.
            if self._mtimes(key) != stamp:
                return None
            dcodes = np.empty(delta.shape, np.int8)
            dscales = np.empty(delta.shape[0], np.float32)
            chunk = _quantize_chunk_rows(delta.shape[1])
            for s in range(0, delta.shape[0], chunk):
                e = min(s + chunk, delta.shape[0])
                dcodes[s:e], dscales[s:e] = topk2.quantize_rows_int8_np(delta[s:e])
            metrics.add("cache.mirror_rows_quantized", delta.shape[0])

        rows_same = keep is None or bool(keep.all())
        if (
            rows_same
            and dcodes is not None
            and sidecar is not None
            and sidecar_stamp == old_stamp
        ):
            appended = self._append_int8_sidecar(
                cdir, meta_path, dcodes, dscales, stamp_s, column,
                int(old_codes.shape[0]),
            )
            if appended is not None:
                metrics.add("cache.mirror_delta_refreshes")
                return appended
            # concurrent winner / header overflow: fall through

        base_c, base_s = old_codes, old_scales
        if keep is not None and not rows_same:
            idx = np.nonzero(keep)[0]
            base_c = np.asarray(old_codes)[idx]
            base_s = np.asarray(old_scales)[idx]
        if dcodes is not None:
            base_c = np.concatenate([np.asarray(base_c), dcodes])
            base_s = np.concatenate([np.asarray(base_s), dscales])
        elif rows_same and sidecar is not None and sidecar_stamp == old_stamp:
            # compaction with the data unchanged: the sidecar files are
            # already correct — re-stamp the meta atomically, no data IO
            import json as json_mod

            try:
                tmp = meta_path + f".tmp-{os.getpid()}"
                with open(tmp, "w") as fh:
                    json_mod.dump(
                        {"stamp": stamp_s, "column": column,
                         "rows": int(old_codes.shape[0]),
                         "dim": int(old_codes.shape[1])},
                        fh,
                    )
                os.replace(tmp, meta_path)
                metrics.add("cache.mirror_delta_refreshes")
                return old_codes, old_scales
            except OSError:
                pass
        metrics.add("cache.mirror_delta_refreshes")
        return self._write_int8_sidecar(
            cdir, meta_path, np.ascontiguousarray(base_c),
            np.ascontiguousarray(base_s), stamp_s, column,
        )

    def _append_int8_sidecar(
        self, cdir, meta_path, dcodes, dscales, stamp_s, column, old_rows: int
    ):
        """Grow the persisted sidecar IN PLACE by the quantized delta
        rows — O(delta) disk I/O. An exclusive flock serializes
        concurrent appenders across processes (interleaved in-place
        writes, unlike the full path's tmp+replace, would corrupt);
        the meta-last protocol still covers crashes. None → caller
        falls back to a full rewrite."""
        import json as json_mod

        from fenix_tpu.utils.metrics import GLOBAL as metrics

        if cdir is None:
            return None
        try:
            import fcntl

            with open(os.path.join(cdir, ".append.lock"), "w") as lk:
                fcntl.flock(lk, fcntl.LOCK_EX)
                if os.path.exists(meta_path):
                    os.unlink(meta_path)  # invalidate before touching data
                codes_path = os.path.join(cdir, "codes.npy")
                scales_path = os.path.join(cdir, "scales.npy")
                if not _npy_append_rows(codes_path, dcodes, old_rows):
                    return None
                if not _npy_append_rows(scales_path, dscales, old_rows):
                    return None
                tmp = meta_path + f".tmp-{os.getpid()}"
                with open(tmp, "w") as fh:
                    json_mod.dump(
                        {"stamp": stamp_s, "column": column,
                         "rows": old_rows + int(dcodes.shape[0]),
                         "dim": int(dcodes.shape[1])},
                        fh,
                    )
                os.replace(tmp, meta_path)
                # reload INSIDE the flock: a concurrent cross-process
                # rewrite between two unlocked loads could pair codes
                # and scales from different revisions (round-5 review)
                codes = np.load(codes_path, mmap_mode="r")
                scales = np.load(scales_path)
                if codes.shape[0] != scales.shape[0]:
                    return None
            metrics.add("cache.int8_sidecar_writes")
            return codes, scales
        except (OSError, ValueError):
            return None

    def host_cell_meta(
        self, coding: str, source: str | Sequence[str], column: str
    ):
        """Host ``(orig [N] int32 original row per cell-sorted
        position, offsets [n_cells+1] int64)`` — the cheap (no D
        factor) half of the cell-sorted host layout: one stable argsort
        of the cell assignments per (revision, index). Probed nomax
        reads and the clustered-int8 build both hang off it."""
        key = _source_key(source)
        paths = self._coded_paths(coding, key, column)
        stamp = self._mtimes(key) + tuple(os.path.getmtime(p) for p in paths)

        def build():
            coding_meta = self.coding(coding)
            n_books, k_book, _ = coding_meta["tensor"].shape
            n_cells = int(k_book) ** int(n_books)
            rows = self.host_table(source).num_rows
            cell_ids = (
                self._host_codes(coding, key, column)
                if rows
                else np.zeros(0, np.int64)
            )
            if cell_ids.shape[0] != rows:
                # table and index revisions span a mutation — callers'
                # stamp re-checks retry
                from fenix_tpu.engine.executor import _StaleRevision

                raise _StaleRevision
            perm = np.argsort(cell_ids.astype(np.int64), kind="stable")
            offsets = np.searchsorted(
                cell_ids[perm], np.arange(n_cells + 1)
            ).astype(np.int64)
            return perm.astype(np.int32), offsets

        return self._memo(
            self._host, (key, column, "host_cell_meta", coding), stamp, build
        )

    def host_clustered_int8(
        self, coding: str, source: str | Sequence[str], column: str
    ):
        """Cell-sorted HOST int8 layout for probed (IVF) search past
        device residency (VERDICT r4 #1): ``(codes_sorted [N, D] int8,
        scales_sorted [N] f32, orig [N] int32 original row per sorted
        position, offsets [n_cells+1] int64)``. Rows sort stably by
        cell id, so every probed cell is a CONTIGUOUS slice — the
        host-side analog of :meth:`clustered` (the reference serves IVF
        at any host-fitting scale because probe pruning is just a
        filter over its mmap'd table, reference index.py:113-126;
        before round 5 this engine refused probed search wherever the
        corpus outgrew device residency).

        Persisted as a revision-stamped sidecar
        (``<int8cache>/<colhash>/ivf-<codinghash>/``, meta written
        LAST) like the flat int8 mirror: the permuted copy is O(N·D)
        once per (revision, index) and a restart memory-maps it.
        Counters: cache.ivf_sidecar_loads / _writes."""
        key = _source_key(source)
        paths = self._coded_paths(coding, key, column)
        stamp = self._mtimes(key) + tuple(os.path.getmtime(p) for p in paths)

        def build():
            import hashlib
            import json as json_mod
            import shutil

            from fenix_tpu.utils.metrics import GLOBAL as metrics

            coding_meta = self.coding(coding)
            n_books, k_book, _ = coding_meta["tensor"].shape
            n_cells = int(k_book) ** int(n_books)

            cdir = None
            if len(key) == 1:
                cdir = os.path.join(
                    table.int8cache_dir(self.root, key[0]),
                    hashlib.sha1(column.encode()).hexdigest()[:16],
                    "ivf-" + hashlib.sha1(coding.encode()).hexdigest()[:16],
                )
            stamp_s = json_mod.dumps(stamp)
            meta_path = cdir and os.path.join(cdir, "meta.json")
            files = ("codes.npy", "scales.npy", "orig.npy", "offsets.npy")

            def read_meta():
                with open(meta_path) as fh:
                    return json_mod.load(fh)

            if cdir is not None and os.path.isdir(cdir):
                try:
                    meta = read_meta()
                    if meta.get("stamp") == stamp_s and meta.get("column") == column:
                        cs = np.load(os.path.join(cdir, "codes.npy"), mmap_mode="r")
                        ss = np.load(os.path.join(cdir, "scales.npy"))
                        og = np.load(os.path.join(cdir, "orig.npy"))
                        offs = np.load(os.path.join(cdir, "offsets.npy"))
                        if (
                            read_meta() == meta
                            and ss.shape[0] == cs.shape[0] == og.shape[0]
                            and offs.shape[0] == n_cells + 1
                        ):
                            metrics.add("cache.ivf_sidecar_loads")
                            return cs, ss, og, offs
                except Exception:
                    pass  # corrupt/stale sidecar: rebuild and replace

            codes8, scales = self.host_int8(source, column)
            rows, d = codes8.shape
            orig, offsets = self.host_cell_meta(coding, source, column)
            if orig.shape[0] != rows:
                from fenix_tpu.engine.executor import _StaleRevision

                raise _StaleRevision
            perm = orig.astype(np.int64)
            scales_sorted = np.asarray(scales)[perm]

            chunk = max(1, (256 << 20) // max(d, 1))  # int8: 1 B/element

            def fill(dst):
                for s in range(0, rows, chunk):
                    e = min(s + chunk, rows)
                    dst[s:e] = codes8[perm[s:e]]

            if cdir is not None:
                try:
                    os.makedirs(cdir, exist_ok=True)
                    _sweep_dead_tmp(cdir)
                    if os.path.exists(meta_path):
                        os.unlink(meta_path)  # invalidate before data
                    tmp = os.path.join(cdir, f".tmp-{os.getpid()}-codes.npy")
                    dst = np.lib.format.open_memmap(
                        tmp, mode="w+", dtype=np.int8, shape=(rows, d)
                    )
                    fill(dst)
                    dst.flush()
                    del dst
                    os.replace(tmp, os.path.join(cdir, "codes.npy"))
                    for arr, fname in (
                        (scales_sorted, "scales.npy"),
                        (orig, "orig.npy"),
                        (offsets, "offsets.npy"),
                    ):
                        tmp = os.path.join(cdir, f".tmp-{os.getpid()}-{fname}")
                        with open(tmp, "wb") as fh:
                            np.save(fh, arr)
                        os.replace(tmp, os.path.join(cdir, fname))
                    tmp = meta_path + f".tmp-{os.getpid()}"
                    with open(tmp, "w") as fh:
                        json_mod.dump(
                            {"stamp": stamp_s, "column": column,
                             "coding": coding, "rows": rows, "dim": d,
                             "n_cells": n_cells},
                            fh,
                        )
                    os.replace(tmp, meta_path)
                    metrics.add("cache.ivf_sidecar_writes")
                    codes_sorted = np.load(
                        os.path.join(cdir, "codes.npy"), mmap_mode="r"
                    )
                    return codes_sorted, scales_sorted, orig, offsets
                except OSError:
                    shutil.rmtree(cdir, ignore_errors=True)

            codes_sorted = np.empty((rows, d), np.int8)
            fill(codes_sorted)
            return codes_sorted, scales_sorted, orig, offsets

        return self._memo_unlocked(
            self._host, (key, column, "host_clustered_int8", coding), stamp, build
        )

    def host_clustered_aux(
        self, coding: str, source: str | Sequence[str], column: str, metric: str
    ):
        """``(mul_s, add_s)`` [N] f32 in the cell-sorted host order:
        the per-row phase-A factors ``aux_mul·scale`` and ``aux_add``
        permuted once per (revision, metric) so the probed host scan
        reads them as contiguous slices per cell (an O(N) gather per
        REQUEST at 100M rows would be ~1 GB of random reads)."""
        from fenix_tpu.ops import distance as distance_ops

        canonical = distance_ops.canonical_metric(metric)
        key = _source_key(source)
        paths = self._coded_paths(coding, key, column)
        stamp = self._mtimes(key) + tuple(os.path.getmtime(p) for p in paths)

        def build():
            _, scales_sorted, orig, _ = self.host_clustered_int8(
                coding, source, column
            )
            hmul, hadd = self.host_aux(source, column, canonical)
            return (
                (scales_sorted * hmul[orig]).astype(np.float32),
                hadd[orig].astype(np.float32),
            )

        return self._memo(
            self._host,
            (key, column, "host_clustered_aux", coding, canonical),
            stamp,
            build,
        )

    def host_aux(self, source: str | Sequence[str], column: str, metric: str):
        """Host (aux_mul [N], aux_add [N]) fp32 — numpy mirror of
        ops.topk2.prepare_aux over the HOST corpus (no mask; request
        filters overlay per query). One corpus pass per revision."""
        from fenix_tpu.ops import distance as distance_ops

        canonical = distance_ops.canonical_metric(metric)
        key = _source_key(source)
        stamp = self._mtimes(key)

        def build():
            host = self.host_matrix(source, column)
            sq = np.einsum("nd,nd->n", host, host, dtype=np.float32)
            if canonical == "l2":
                return np.ones_like(sq), -sq
            if canonical == "cosine":
                return (
                    (1.0 / np.maximum(np.sqrt(sq), 1e-12)).astype(np.float32),
                    np.zeros_like(sq),
                )
            return np.ones_like(sq), np.zeros_like(sq)

        return self._memo(self._host, (key, column, "host_aux", canonical), stamp, build)

    def host_filter_mask(self, source: str | Sequence[str], filt) -> np.ndarray:
        """Host ``[N]`` bool mask for a predicate, memoized per
        (predicate, revision) in the bounded mask LRU — the host-rescore
        and streaming paths re-apply validity per candidate row and must
        not re-evaluate an O(N) Arrow predicate per request."""
        key = _source_key(source)
        stamp = self._mtimes(key)
        ckey = (key, "host", filt.to_json())
        with self._lock:
            hit = self._masks.get(ckey)
            if hit is not None and hit[0] == stamp:
                self._masks.move_to_end(ckey)
                return hit[1]
        mask = np.asarray(filt.mask(self.host_table(source)), dtype=bool)
        with self._lock:
            self._masks[ckey] = (stamp, mask)
            self._masks.move_to_end(ckey)
            while len(self._masks) > _MASK_CACHE_LIMIT:
                self._masks.popitem(last=False)
        return mask

    def host_column_views(
        self,
        source: str | Sequence[str],
        data: pa.Table,
        token,
        variant: "str | None" = None,
    ) -> dict:
        """Zero-copy numpy views of the RESULT-GATHERABLE host columns
        of ``data``: null-free int/float/bool primitives (1-D views) and
        plain float FixedSizeList vectors ([N, D] views).

        Feeds the executor's numpy result-materialization fast path
        (gather_results): Arrow ``take`` over the full table measured
        4.2 ms of a config-5 batch on chip (benchmarks/
        exp_cfg5_decomp.py, VERDICT r3 weak #3) — a threaded native
        gather over pre-combined views does the same materialization in
        a fraction. Extension-typed, string, and nullable columns are
        ABSENT from the dict; the executor falls back to Arrow take per
        column (dequantizing a quint8 column into a plain float result
        would silently change the result schema).

        Views are built FROM THE CALLER'S snapshot table and memoized
        under the caller's revision ``token`` (``variant`` separates
        the plain and coded-table shapes) — a concurrent mutation can
        never pair a newer view with older row ids, the same binding
        rule as every other snapshot consumer."""
        key = _source_key(source)
        ckey = (key, "host_column_views", variant)

        def build() -> dict:
            views: dict = {}
            for name in data.column_names:
                col = data.column(name)
                t = col.type
                try:
                    if col.null_count:
                        continue
                    if isinstance(t, pa.ExtensionType):
                        continue
                    if pa.types.is_fixed_size_list(t) and pa.types.is_floating(
                        t.value_type
                    ):
                        if col.num_chunks > 1:
                            # multi-chunk (live delta parts): a numpy
                            # view would be a corpus-sized COPY — never
                            # worth a result-materialization fast path
                            # on its own. Reuse the host_matrix copy if
                            # the residency path already built one for
                            # this revision (fp32 columns only — the
                            # matrix is canonicalized to fp32);
                            # otherwise Arrow take serves this column.
                            hit = self._host.get((key, name, "host_matrix"))
                            if (
                                pa.types.is_float32(t.value_type)
                                and hit is not None
                                and hit[0] == token[: len(hit[0])]
                            ):
                                views[name] = (hit[1], t.value_type)
                            continue
                        views[name] = (ingest.fixed_size_list_to_numpy(col), t.value_type)
                    elif (
                        pa.types.is_integer(t)
                        or pa.types.is_floating(t)
                        or pa.types.is_boolean(t)
                    ):
                        views[name] = (ingest.scalar_column_to_numpy(col), None)
                except (pa.ArrowInvalid, ValueError):
                    continue  # non-viewable layout: Arrow take fallback
            return views

        return self._memo(self._host, ckey, token, build)

    def int8_solo(self, source: str | Sequence[str], column: str):
        """Per-row symmetric int8 device copy ``(v8, sv)`` built WITHOUT
        fp32 device residency: scales and codes are computed on the host
        and uploaded in donated chunks, so peak HBM is the int8 copy
        alone (~N·D bytes) — the dual-residency route
        (:meth:`matrix_int8`) quantizes FROM a resident fp32 matrix and
        cannot fit the 10M×768 at-spec corpus on a 16 GB chip
        (VERDICT r3 #1; measured RESOURCE_EXHAUSTED in
        benchmarks/exp_16m.py). Quantization is the shared host mirror
        of ops.topk2.quantize_corpus_int8 (quantize_rows_int8_np —
        same scale/floor/round/clip; scales 1-ulp from the device
        form, which the fp32 rescore against these SAME scales makes
        irrelevant)."""
        key = _source_key(source)
        stamp = self._mtimes(key)

        ckey = (key, column, "int8_solo")
        hit = self._device.get(ckey)
        if hit is not None and hit[0] != stamp and len(key) == 1:
            # grow OUTSIDE self._lock: _grow_int8_solo calls host_int8,
            # whose _memo_unlocked builder PUBLISHES under the lock —
            # waiting on an in-flight mirror build while holding the
            # lock would deadlock the whole cache (round-5 review).
            # Publish-time guards make the lockless compute safe: the
            # entry must still be the one we grew from, and the table
            # must still be at the stamp we grew to (matrix()'s own
            # label-content binding rule).
            grown = self._grow_int8_solo(key, column, hit[0], hit[1], stamp)
            if grown is not None:
                with self._lock:
                    cur = self._device.get(ckey)
                    if cur is not None and cur[0] == hit[0] and self._mtimes(
                        key
                    ) == stamp:
                        self._device[ckey] = (stamp, grown)
                        self._touch(ckey)
                        self.incremental_refreshes += 1
                        return grown
                # lost a race (someone else refreshed, or the table
                # moved again): fall through to the memoized build

        def build():
            import jax
            import jax.numpy as jnp

            # codes come from the host int8 mirror — shared with the
            # streaming path, persisted as a sidecar, so a server
            # restart uploads straight from the mmap'd codes instead
            # of re-reading + re-quantizing the fp32 corpus
            codes, scales = self.host_int8(source, column)
            rows, d = codes.shape
            n_pad = max(ingest.round_up(rows, self.block), self.block)
            chunk = min(n_pad, 32 * self.block)
            sv_np = np.full(n_pad, 1e-30, np.float32)
            sv_np[:rows] = scales
            upd = _int8_upload_fn()
            v8 = jnp.zeros((n_pad, d), jnp.int8)
            for s in range(0, rows, chunk):
                e = min(s + chunk, rows)
                c8 = np.asarray(codes[s:e])
                if e - s != chunk:  # ragged tail: pad to the compiled shape
                    c8 = np.concatenate(
                        [c8, np.zeros((min(chunk, n_pad - s) - (e - s), d), np.int8)]
                    )
                v8 = upd(v8, jnp.asarray(c8), np.int32(s))
            return (
                ingest.DeviceColumn(data=v8, rows=rows),
                ingest.DeviceColumn(data=jnp.asarray(sv_np), rows=rows),
            )

        return self._memo(self._device, ckey, stamp, build)

    def _grow_int8_solo(self, key, column, old_stamp, old, new_stamp):
        """Extend the int8-RESIDENT device copy by appended rows only —
        the device half of the incremental-mirror standard: the delta's
        codes come pre-quantized from :meth:`host_int8` (itself
        O(delta) on append hops), so a small append costs delta upload
        bytes instead of an N·D re-upload over the link. Non-append
        hops (deletes, compactions) rebuild — that rebuild is an
        upload-only pass from the refreshed mirror, never a re-quantize.
        None → caller rebuilds."""
        import jax.numpy as jnp

        if table.append_delta(old_stamp[0], new_stamp[0]) is None:
            return None
        v8, sv = old
        codes, scales = self.host_int8(key[0], column)
        # the mirror stamps itself against the CURRENT table: if the
        # table moved again while we waited on its build, its rows do
        # not correspond to `new_stamp` — rebuild instead of binding
        # newer rows to an older stamp label
        if self._mtimes(key) != new_stamp:
            return None
        new_rows = codes.shape[0]
        d = v8.data.shape[1]
        if new_rows <= v8.rows or codes.shape[1] != d:
            return None  # raced mutation / schema drift
        delta_c = np.asarray(codes[v8.rows : new_rows])
        delta_s = np.asarray(scales[v8.rows : new_rows], np.float32)
        cold_pad = max(
            ingest.round_up(new_rows, self.block), self.block, v8.rows_padded
        )
        # quantize the delta height so repeated small appends reuse one
        # compiled update (same rule as _grow_matrix)
        delta_pad = ingest.round_up(delta_c.shape[0], 256)
        if v8.rows + delta_pad > cold_pad:
            delta_pad = cold_pad - v8.rows
        if delta_pad != delta_c.shape[0]:
            delta_c = np.concatenate(
                [delta_c, np.zeros((delta_pad - delta_c.shape[0], d), np.int8)]
            )
            delta_s = np.concatenate(
                [delta_s,
                 np.full(delta_pad - delta_s.shape[0], 1e-30, np.float32)]
            )
        return (
            ingest.DeviceColumn(
                data=_grow_update(v8.data, jnp.asarray(delta_c), v8.rows, cold_pad),
                rows=new_rows,
            ),
            ingest.DeviceColumn(
                data=_grow1_update(
                    sv.data, jnp.asarray(delta_s), v8.rows, cold_pad, 1e-30
                ),
                rows=new_rows,
            ),
        )

    def int8_solo_aux(self, source: str | Sequence[str], column: str, metric: str):
        """Device ``(aux_mul, aux_add)`` [N_pad] for the int8-resident
        scan, uploaded FROM the host aux (8 B/row — the corpus itself
        never lands on device in fp32). Padding rows carry −inf."""
        import jax.numpy as jnp

        from fenix_tpu.ops import distance as distance_ops

        canonical = distance_ops.canonical_metric(metric)
        key = _source_key(source)
        stamp = self._mtimes(key)

        def build():
            mul, add = self.host_aux(source, column, canonical)
            rows = mul.shape[0]
            n_pad = max(ingest.round_up(rows, self.block), self.block)
            mul_p = np.ones(n_pad, np.float32)
            mul_p[:rows] = mul
            add_p = np.full(n_pad, np.float32(distance_ops.NEG_INF), np.float32)
            add_p[:rows] = add
            return jnp.asarray(mul_p), jnp.asarray(add_p)

        return self._memo(
            self._device, (key, column, "int8_solo_aux", canonical), stamp, build
        )

    def sharded_int8_solo(self, source: str | Sequence[str], column: str):
        """Row-sharded int8 device copy ``(v8 [N_pad, D] P(axes, None),
        sv [N_pad] P(axes))`` over the serving mesh, built from the host
        int8 mirror WITHOUT fp32 device residency — the mesh-composed
        int8-resident mode (VERDICT r4 next #2): each chip holds 1/S of
        the int8 copy, so the int8 ceiling scales with the mesh. Shards
        fill via ``jax.make_array_from_callback`` slicing the (mmap'd)
        mirror — peak host RAM is one shard's slice, never a padded
        full-corpus copy."""
        import jax

        key = _source_key(source)
        stamp = self._mtimes(key)

        def build():
            import jax.numpy as jnp

            codes, scales = self.host_int8(source, column)
            rows, d = codes.shape
            n_pad = max(
                ingest.round_up(rows, self._shard_block), self._shard_block
            )

            def slice_codes(idx):
                s, e = idx[0].start or 0, idx[0].stop or n_pad
                out = np.zeros((e - s, d), np.int8)
                if s < rows:
                    out[: min(e, rows) - s] = codes[s : min(e, rows)]
                return out

            def slice_scales(idx):
                s, e = idx[0].start or 0, idx[0].stop or n_pad
                out = np.full(e - s, 1e-30, np.float32)
                if s < rows:
                    out[: min(e, rows) - s] = scales[s : min(e, rows)]
                return out

            v8 = jax.make_array_from_callback(
                (n_pad, d), self._row_sharding(2), slice_codes
            )
            sv = jax.make_array_from_callback(
                (n_pad,), self._row_sharding(1), slice_scales
            )
            return (
                ingest.DeviceColumn(data=v8, rows=rows),
                ingest.DeviceColumn(data=sv, rows=rows),
            )

        return self._memo(
            self._device, (key, column, "sharded_int8_solo"), stamp, build
        )

    def sharded_int8_solo_aux(
        self, source: str | Sequence[str], column: str, metric: str
    ):
        """Row-sharded ``(aux_mul, aux_add)`` [N_pad] for the
        mesh-composed int8-resident scan, from the host aux (8 B/row);
        padding rows carry −inf."""
        import jax

        from fenix_tpu.ops import distance as distance_ops

        canonical = distance_ops.canonical_metric(metric)
        key = _source_key(source)
        stamp = self._mtimes(key)

        def build():
            mul, add = self.host_aux(source, column, canonical)
            rows = mul.shape[0]
            n_pad = max(
                ingest.round_up(rows, self._shard_block), self._shard_block
            )

            def fill(host, pad_value):
                def cb(idx):
                    s, e = idx[0].start or 0, idx[0].stop or n_pad
                    out = np.full(e - s, pad_value, np.float32)
                    if s < rows:
                        out[: min(e, rows) - s] = host[s : min(e, rows)]
                    return out

                return jax.make_array_from_callback(
                    (n_pad,), self._row_sharding(1), cb
                )

            return (
                fill(mul, 1.0),
                fill(add, np.float32(distance_ops.NEG_INF)),
            )

        return self._memo(
            self._device,
            (key, column, "sharded_int8_solo_aux", canonical),
            stamp,
            build,
        )

    def _coded_paths(self, coding: str, key: tuple[str, ...], column: str) -> list[str]:
        from fenix_tpu import index as index_mod

        return [index_mod.path_of(self.root, coding, s, column) for s in key]

    def _synced_index(self, coding: str, source: str, column: str) -> pa.Table:
        """The index table for one source, RESYNCED if its row count
        diverges from the source table.

        A mismatch means a reader landed inside a writer's
        table-then-index publish window, or a crash left the pair
        desynced (append: index short; delete: index long). Taking the
        catalog lock waits out an in-flight writer; if the mismatch
        persists, the assignment is rebuilt from the current table —
        self-healing instead of failing every probed search until an
        operator runs sync_index."""
        from fenix_tpu import index as index_mod

        path = index_mod.path_of(self.root, coding, source, column)
        idx = arrow.load(path)
        if idx.num_rows == table.load(self.root, source).num_rows:
            return idx

        from fenix_tpu.io.locks import catalog_lock

        with catalog_lock(self.root):
            idx = arrow.load(path)
            data = table.load(self.root, source)
            if idx.num_rows == data.num_rows:
                return idx  # writer finished while we waited
            import logging

            logging.getLogger("fenix_tpu").warning(
                "index %r over %r/%r has %d rows vs table's %d — resyncing",
                coding, source, column, idx.num_rows, data.num_rows,
            )
            index_mod.make(self.root, coding, source, column)
            return arrow.load(path)

    def coded_table(self, coding: str, source: str | Sequence[str], column: str) -> pa.Table:
        """Host table with the ``__CODED_ID__`` column joined on
        (reference index.py:19-34). Memoized on the table AND index
        file mtimes — previously re-joined from disk per query."""
        key = _source_key(source)
        paths = self._coded_paths(coding, key, column)
        stamp = self._mtimes(key) + tuple(os.path.getmtime(p) for p in paths)

        def build() -> pa.Table:
            parts = [
                table.join(
                    table.load(self.root, s),
                    self._synced_index(coding, s, column),
                    axis=1,
                )
                for s in key
            ]
            return table.join(*parts)

        return self._memo(self._host, (key, column, "coded_table", coding), stamp, build)

    def _host_codes(self, coding: str, key: tuple[str, ...], column: str) -> np.ndarray:
        """Concatenated (resync-checked) cell ids for the sources."""
        from fenix_tpu import index as index_mod

        parts = [
            ingest.scalar_column_to_numpy(
                self._synced_index(coding, s, column).column(index_mod.CODE_COL)
            )
            for s in key
        ]
        return np.concatenate(parts) if len(parts) > 1 else parts[0]

    # -- device columns ---------------------------------------------------

    def matrix(self, source: str | Sequence[str], column: str) -> ingest.DeviceColumn:
        """Padded ``[N_pad, D]`` fp32 vector column in HBM.

        Append-only table revisions refresh INCREMENTALLY: only the new
        delta-part rows cross the host→device link and the buffer
        extends on device — the corpus is not re-ingested. (Every other
        device entry — aux, bf16/int8 scan copies, clustered layouts —
        derives from this array ON device, so their rebuilds cost HBM
        bandwidth, not transfer.) Deletes/overwrites/compactions rebuild
        from the host as before."""
        key = _source_key(source)
        stamp = self._mtimes(key)
        ckey = (key, column, "matrix")

        hit = self._device.get(ckey)
        if hit is not None and hit[0] == stamp:
            self._touch(ckey)
            return hit[1]

        with self._lock:  # serialize fills like _memo (one grow/build)
            hit = self._device.get(ckey)
            if hit is not None and hit[0] == stamp:
                return hit[1]
            if hit is not None and len(key) == 1:
                grown = self._grow_matrix(key[0], column, hit[0][0], hit[1], stamp[0])
                shrunk = None
                if grown is None:
                    shrunk = self._shrink_matrix(
                        key[0], column, hit[0][0], hit[1], stamp[0], sharded=False
                    )
                refreshed = grown if grown is not None else shrunk
                # revalidate: a compaction between the stamp read and
                # the part loads can fold AND REUSE part names (ids
                # reset) — the grown buffer would then hold wrong rows
                # under a stale stamp; rebuild instead
                if refreshed is not None and self._mtimes(key) == stamp:
                    self._device[ckey] = (stamp, refreshed)
                    self._touch(ckey)
                    self._maybe_evict(ckey)
                    if grown is not None:
                        self.incremental_refreshes += 1
                    else:
                        self.lineage_refreshes += 1
                    return refreshed

            # Full build with label↔content BINDING: the stamp stored
            # with the entry must describe the revision the rows came
            # from — an entry whose content is newer than its label
            # makes the next grow re-append rows it already holds
            # (plain _memo entries tolerate the mismatch because their
            # consumers only ever rebuild).
            from fenix_tpu.io.locks import read_stable

            value, s1 = read_stable(
                lambda: self._mtimes(key),
                lambda: ingest.to_device_matrix(
                    table.load(self.root, key if len(key) > 1 else key[0]).column(
                        column
                    ),
                    block=self.block,
                ),
                f"table {source!r}",
            )
            self._device[ckey] = (s1, value)
            self._touch(ckey)
            self._maybe_evict(ckey)
            return value

    def _grow_matrix(
        self,
        source: str,
        column: str,
        old_stamp,
        old: ingest.DeviceColumn,
        new_stamp,
    ) -> "ingest.DeviceColumn | None":
        """Extend a cached device matrix by the rows of newly appended
        delta parts; None when the revision change is not append-only
        (caller falls back to a full rebuild)."""
        import jax.numpy as jnp

        delta_names = table.append_delta(old_stamp, new_stamp)
        if not delta_names:
            return None
        try:
            parts = table.load_parts(self.root, source, delta_names)
            delta = ingest.fixed_size_list_to_numpy(parts.column(column)).astype(
                np.dtype(old.data.dtype), copy=False
            )
        except (FileNotFoundError, KeyError, TypeError):
            return None  # raced mutation / schema drift: full rebuild

        new_rows = old.rows + delta.shape[0]
        # a cold rebuild of the same data would pad to exactly this —
        # never exceed it, or the grown shape diverges from rebuilds and
        # every search kernel recompiles for the one-off shape
        cold_pad = max(
            ingest.round_up(new_rows, self.block), self.block, old.rows_padded
        )
        # quantize the delta height so repeated small appends reuse one
        # compiled update (the zero tail it writes IS the expected
        # padding), clamped into the cold-rebuild capacity when it fits
        delta_pad = ingest.round_up(delta.shape[0], 256)
        if old.rows + delta_pad > cold_pad:
            delta_pad = cold_pad - old.rows
        new_pad = cold_pad
        if delta_pad != delta.shape[0]:
            from fenix_tpu import native

            delta = native.pack_rows(np.ascontiguousarray(delta), delta_pad)
        return ingest.DeviceColumn(
            data=_grow_update(old.data, jnp.asarray(delta), old.rows, new_pad),
            rows=new_rows,
        )

    def _shrink_matrix(
        self,
        source: str,
        column: str,
        old_stamp,
        old: ingest.DeviceColumn,
        new_stamp,
        *,
        sharded: bool,
    ) -> "ingest.DeviceColumn | None":
        """Refresh a cached device matrix across a DELETE or COMPACTION
        revision via the recorded keep-mask lineage
        (fenix_tpu.io.table.record_lineage): kept rows gather ON DEVICE —
        only the kept-row int32 index crosses the host link (4 B/row vs
        4·D B/row for a re-stream), and identity hops (compactions)
        reuse the buffer outright. Composes with the append grow when
        parts sit on top of the hop (upsert = delete + append). None →
        not this hop (caller rebuilds from the host)."""
        lin = table.lineage(self.root, source)
        if lin is None:
            return None
        lin_old, lin_new, keep = lin
        if lin_old != old_stamp or keep.shape[0] != old.rows:
            return None

        import jax.numpy as jnp

        if bool(keep.all()):
            col = old  # compaction: same rows, new base
        else:
            block = self._shard_block if sharded else self.block
            idx = np.nonzero(keep)[0].astype(np.int32)
            new_rows = int(idx.size)
            new_pad = max(ingest.round_up(new_rows, block), block)
            idx_full = np.zeros(new_pad, np.int32)
            idx_full[:new_rows] = idx
            fn = _compact_fn(self._row_sharding(2) if sharded else None)
            data = fn(old.data, jnp.asarray(idx_full), jnp.int32(new_rows))
            col = ingest.DeviceColumn(data=data, rows=new_rows)
        if new_stamp == lin_new:
            return col
        # parts on top of the hop: grow the shrunk buffer by the delta
        grower = self._grow_sharded_matrix if sharded else self._grow_matrix
        return grower(source, column, lin_new, col, new_stamp)

    def coded_ids(
        self,
        coding: str,
        source: str | Sequence[str],
        column: str,
        *,
        sharded: bool = False,
    ) -> ingest.DeviceColumn:
        """Padded ``[N_pad]`` int32 cell-id column in HBM (padding = −1,
        which never matches a probe cell). With ``sharded=True`` the
        column is row-sharded over the serving mesh, padded like
        :meth:`sharded_matrix` so it stays row-aligned with it."""
        key = _source_key(source)
        stamp = self._mtimes(key)

        def build() -> ingest.DeviceColumn:
            codes = self._host_codes(coding, key, column)
            return ingest.to_device_vector(
                codes.astype(np.int32),
                block=self._shard_block if sharded else self.block,
                fill=-1,
                sharding=self._row_sharding(1) if sharded else None,
            )

        return self._memo(
            self._device, (key, column, "coded", coding, sharded), stamp, build
        )

    def scalar(
        self, source: str | Sequence[str], column: str, *, sharded: bool = False
    ) -> ingest.DeviceColumn:
        """Padded 1-D numeric column in HBM (join keys, filter columns,
        group-by columns). Padding value is 0 with validity carried by
        ``rows`` — callers mask the tail themselves. With
        ``sharded=True`` the column is row-sharded and padded like
        :meth:`sharded_matrix` (row-aligned with it)."""
        key = _source_key(source)
        stamp = self._mtimes(key)

        def build() -> ingest.DeviceColumn:
            data = self.host_table(source)
            host = _require_int32(
                ingest.scalar_column_to_numpy(data.column(column)), column
            )
            return ingest.to_device_vector(
                host,
                block=self._shard_block if sharded else self.block,
                sharding=self._row_sharding(1) if sharded else None,
            )

        return self._memo(self._device, (key, column, "scalar", sharded), stamp, build)

    def _base_matrix(
        self, source: str | Sequence[str], column: str, sharded: bool
    ) -> ingest.DeviceColumn:
        return (
            self.sharded_matrix(source, column)
            if sharded
            else self.matrix(source, column)
        )

    def matrix_bf16(
        self, source: str | Sequence[str], column: str, *, sharded: bool = False
    ) -> ingest.DeviceColumn:
        """bf16 copy of the vector column for half-traffic phase-1 scans
        (opt-in ``precision="bf16"``; fp32 stays resident for rescore).
        Element-wise cast, so with ``sharded=True`` the base matrix's
        row sharding propagates."""
        import jax.numpy as jnp

        key = _source_key(source)
        stamp = self._mtimes(key)

        def build() -> ingest.DeviceColumn:
            full = self._base_matrix(source, column, sharded)
            return ingest.DeviceColumn(
                data=full.data.astype(jnp.bfloat16), rows=full.rows
            )

        return self._memo(
            self._device, (key, column, "matrix_bf16", sharded), stamp, build
        )

    def matrix_int8(
        self, source: str | Sequence[str], column: str, *, sharded: bool = False
    ):
        """Per-row symmetric int8 copy ``(v8, sv)`` of the vector column
        for quarter-traffic phase-1 scans (opt-in ``precision="int8"``;
        fp32 stays resident for the exact rescore). Padding rows are
        zeros and quantize to zeros with scale ~0. Quantization is
        row-wise, so with ``sharded=True`` the row sharding propagates."""
        from fenix_tpu.ops import topk2

        key = _source_key(source)
        stamp = self._mtimes(key)

        def build():
            full = self._base_matrix(source, column, sharded)
            v8, sv = topk2.quantize_corpus_int8(full.data)
            return (
                ingest.DeviceColumn(data=v8, rows=full.rows),
                ingest.DeviceColumn(data=sv, rows=full.rows),
            )

        return self._memo(
            self._device, (key, column, "matrix_int8", sharded), stamp, build
        )

    # -- mesh-sharded columns (multi-device serving) -----------------------

    @property
    def mesh(self):
        """Serving mesh, or None for single-device execution. When a
        mesh is active the executor's top-k paths run the shard_map
        kernels from fenix_tpu.parallel.search over row-sharded columns
        — only k candidates per (shard, query) cross the interconnect."""
        if self._mesh == "auto":
            from fenix_tpu.parallel import mesh as mesh_mod

            self._mesh = mesh_mod.serving_mesh()
        return self._mesh

    def _row_sharding(self, ndim: int):
        from fenix_tpu.parallel.mesh import row_sharding

        return row_sharding(self.mesh, ndim)

    @property
    def _shard_block(self) -> int:
        # every shard holds a whole number of scan blocks
        return self.block * int(self.mesh.devices.size)

    def sharded_matrix(self, source: str | Sequence[str], column: str) -> ingest.DeviceColumn:
        """Row-sharded ``[N_pad, D]`` fp32 vector column over the mesh.
        Rows split contiguously, so a shard-local index plus the shard's
        row offset IS the global row id (padding sits at the tail).

        Append-only revisions refresh INCREMENTALLY like the
        single-device :meth:`matrix`: only the delta rows cross the
        host→device link. Contiguous sharding survives the append
        because global row positions never move — new rows land in the
        padded tail, and when they outgrow it the capacity extension
        reshards EXISTING rows over the interconnect (device→device),
        still uploading only the delta (VERDICT r1 #9)."""
        key = _source_key(source)
        stamp = self._mtimes(key)
        ckey = (key, column, "sharded_matrix")

        hit = self._device.get(ckey)
        if hit is not None and hit[0] == stamp:
            self._touch(ckey)
            return hit[1]

        with self._lock:
            hit = self._device.get(ckey)
            if hit is not None and hit[0] == stamp:
                return hit[1]
            if hit is not None and len(key) == 1:
                grown = self._grow_sharded_matrix(
                    key[0], column, hit[0][0], hit[1], stamp[0]
                )
                shrunk = None
                if grown is None:
                    shrunk = self._shrink_matrix(
                        key[0], column, hit[0][0], hit[1], stamp[0], sharded=True
                    )
                refreshed = grown if grown is not None else shrunk
                # revalidate like _grow_matrix: a compaction in the gap
                # can fold and REUSE part names — rebuild instead
                if refreshed is not None and self._mtimes(key) == stamp:
                    self._device[ckey] = (stamp, refreshed)
                    self._touch(ckey)
                    self._maybe_evict(ckey)
                    if grown is not None:
                        self.incremental_refreshes += 1
                    else:
                        self.lineage_refreshes += 1
                    return refreshed

            from fenix_tpu.io.locks import read_stable

            value, s1 = read_stable(
                lambda: self._mtimes(key),
                lambda: ingest.to_device_matrix(
                    table.load(
                        self.root, key if len(key) > 1 else key[0]
                    ).column(column),
                    block=self._shard_block,
                    sharding=self._row_sharding(2),
                ),
                f"table {source!r}",
            )
            self._device[ckey] = (s1, value)
            self._touch(ckey)
            self._maybe_evict(ckey)
            return value

    def _grow_sharded_matrix(
        self,
        source: str,
        column: str,
        old_stamp,
        old: ingest.DeviceColumn,
        new_stamp,
    ) -> "ingest.DeviceColumn | None":
        """Extend a cached ROW-SHARDED device matrix by newly appended
        delta-part rows; None when the revision change is not
        append-only (caller does a full rebuild)."""
        delta_names = table.append_delta(old_stamp, new_stamp)
        if not delta_names:
            return None
        try:
            parts = table.load_parts(self.root, source, delta_names)
            delta = ingest.fixed_size_list_to_numpy(parts.column(column)).astype(
                np.dtype(old.data.dtype), copy=False
            )
        except (FileNotFoundError, KeyError, TypeError):
            return None  # raced mutation / schema drift: full rebuild

        new_rows = old.rows + delta.shape[0]
        # cold-rebuild parity: to_device_matrix(block=_shard_block) pads
        # to exactly this — matching it keeps compiled kernel shapes
        # identical between grown and rebuilt caches. Clamped to the
        # cached capacity like _grow_matrix: a cached entry with extra
        # headroom must not drive `extra` negative below.
        cold_pad = max(
            ingest.round_up(new_rows, self._shard_block),
            self._shard_block,
            old.rows_padded,
        )
        delta_pad = ingest.round_up(delta.shape[0], 256)
        if old.rows + delta_pad > cold_pad:
            delta_pad = cold_pad - old.rows
        if delta_pad != delta.shape[0]:
            from fenix_tpu import native

            delta = native.pack_rows(np.ascontiguousarray(delta), delta_pad)

        import numpy as _np

        fn = _sharded_grow_fn(self._row_sharding(2))
        grown = fn(old.data, delta, _np.int32(old.rows), new_pad=cold_pad)
        return ingest.DeviceColumn(data=grown, rows=new_rows)

    def sharded_validity(self, source: str | Sequence[str], column: str):
        """Row-sharded bool ``[N_pad]`` marking real (non-padding) rows."""
        key = _source_key(source)
        stamp = self._mtimes(key)

        def build():
            col = self.sharded_matrix(source, column)
            # computed on device (iota < rows): zero host mask bytes on
            # cold builds AND on append refreshes
            fn = _sharded_valid_fn(self._row_sharding(1))
            return fn(np.int32(col.rows), n_pad=col.rows_padded)

        return self._memo(self._device, (key, column, "sharded_validity"), stamp, build)

    def sharded_aux(self, source: str | Sequence[str], column: str, metric: str):
        """Row-sharded (aux_mul, aux_add) — one corpus pass at fill time,
        sharding propagates through the row-wise prepare_aux."""
        from fenix_tpu.ops import distance as distance_ops
        from fenix_tpu.parallel import search as psearch

        canonical = distance_ops.canonical_metric(metric)
        key = _source_key(source)
        stamp = self._mtimes(key)

        def build():
            col = self.sharded_matrix(source, column)
            return psearch.shard_aux(
                col.data, self.sharded_validity(source, column), canonical
            )

        return self._memo(self._device, (key, column, "sharded_aux", canonical), stamp, build)

    def sharded_clustered_meta(self, coding: str, source: str | Sequence[str], column: str):
        """Host side of the PER-SHARD clustered IVF layout.

        Each shard's contiguous row range is independently sorted by
        cell id (padding last), so probed cells occupy contiguous LOCAL
        ranges per shard. Returns ``(perm_local [N_pad] int32 — local
        sort index per slot, offsets [S, n_cells+1] int64 — per-shard
        cell offset tables, orig_global [N_pad] int32 — original global
        row id per sorted slot, −1 padding)``."""
        key = _source_key(source)
        paths = self._coded_paths(coding, key, column)
        stamp = self._mtimes(key) + tuple(os.path.getmtime(p) for p in paths)

        def build():
            coded = self.coded_ids(coding, source, column, sharded=True)
            codes = np.full(coded.rows_padded, -1, dtype=np.int64)
            codes[: coded.rows] = self._host_codes(coding, key, column)
            coding_meta = self.coding(coding)
            n_books, k_book, _ = coding_meta["tensor"].shape
            n_cells = int(k_book) ** int(n_books)

            n_shards = int(self.mesh.devices.size)
            n_pad = codes.shape[0]
            per = n_pad // n_shards
            intmax = np.iinfo(np.int64).max

            perm_local = np.empty(n_pad, np.int32)
            orig_global = np.empty(n_pad, np.int32)
            offsets = np.empty((n_shards, n_cells + 1), np.int64)
            for s in range(n_shards):
                sl = slice(s * per, (s + 1) * per)
                keys = np.where(codes[sl] >= 0, codes[sl], intmax)
                p = np.argsort(keys, kind="stable").astype(np.int32)
                perm_local[sl] = p
                sorted_keys = keys[p]
                offsets[s] = np.searchsorted(sorted_keys, np.arange(n_cells + 1))
                orig_global[sl] = np.where(
                    sorted_keys != intmax, s * per + p, -1
                ).astype(np.int32)
            return perm_local, offsets, orig_global

        return self._memo(
            self._device, (key, column, "sharded_clustered_meta", coding), stamp, build
        )

    def sharded_clustered(self, coding: str, source: str | Sequence[str], column: str):
        """Device side of the per-shard clustered layout:
        ``(corpus_sorted, coded_sorted, orig_ids)`` row-sharded
        DeviceColumns. The permutation gathers ON DEVICE, shard-locally
        (parallel.search.permute_rows_sharded) — no host copy."""
        import jax

        from fenix_tpu.parallel import search as psearch

        key = _source_key(source)
        paths = self._coded_paths(coding, key, column)
        stamp = self._mtimes(key) + tuple(os.path.getmtime(p) for p in paths)

        def build():
            self.clustered_builds += 1
            full = self.sharded_matrix(source, column)
            coded = self.coded_ids(coding, source, column, sharded=True)
            perm_local, _, orig_global = self.sharded_clustered_meta(
                coding, source, column
            )
            perm_dev = jax.device_put(perm_local, self._row_sharding(1))
            return (
                ingest.DeviceColumn(
                    data=psearch.permute_rows_sharded(self.mesh, full.data, perm_dev),
                    rows=full.rows,
                ),
                ingest.DeviceColumn(
                    data=psearch.permute_rows_sharded(self.mesh, coded.data, perm_dev),
                    rows=full.rows,
                ),
                ingest.DeviceColumn(
                    data=jax.device_put(orig_global, self._row_sharding(1)),
                    rows=full.rows,
                ),
            )

        return self._memo(
            self._device, (key, column, "sharded_clustered", coding), stamp, build
        )

    def sharded_clustered_aux(
        self, coding: str, source: str | Sequence[str], column: str, metric: str
    ):
        """(aux_mul, aux_add) in the per-shard sorted order."""
        from fenix_tpu.ops import distance as distance_ops
        from fenix_tpu.parallel import search as psearch

        canonical = distance_ops.canonical_metric(metric)
        key = _source_key(source)
        paths = self._coded_paths(coding, key, column)
        stamp = self._mtimes(key) + tuple(os.path.getmtime(p) for p in paths)

        def build():
            corpus_sorted, _, orig = self.sharded_clustered(coding, source, column)
            return psearch.shard_aux(corpus_sorted.data, orig.data >= 0, canonical)

        return self._memo(
            self._device,
            (key, column, "sharded_clustered_aux", coding, canonical),
            stamp,
            build,
        )

    def metric_aux(self, source: str | Sequence[str], column: str, metric: str):
        """Cached per-row (aux_mul, aux_add) for the fused two-phase
        score (fenix_tpu.ops.topk2.prepare_aux) with padding rows
        pre-masked to −inf. Request filters overlay on top per query."""
        import jax.numpy as jnp

        from fenix_tpu.ops import distance as distance_ops
        from fenix_tpu.ops import topk2

        canonical = distance_ops.canonical_metric(metric)
        key = _source_key(source)
        stamp = self._mtimes(key)

        def build():
            col = self.matrix(source, column)
            valid = jnp.arange(col.rows_padded) < col.rows
            return topk2.prepare_aux(col.data, valid, canonical)

        return self._memo(self._device, (key, column, "aux", canonical), stamp, build)

    def sorted_key(self, source: str | Sequence[str], column: str):
        """Pre-sorted (keys, original positions) for lookup joins —
        built once per attrs table, probed per query
        (fenix_tpu.ops.relational.join_lookup_sorted)."""
        from fenix_tpu.ops import relational

        key = _source_key(source)
        stamp = self._mtimes(key)

        def build():
            col = self.scalar(source, column)
            import jax.numpy as jnp

            keys = col.data.astype(jnp.int32)  # scalar() guards the range
            # padding rows carry key 0; exclude them by setting max-int
            pad_key = jnp.iinfo(keys.dtype).max
            valid = jnp.arange(col.rows_padded) < col.rows
            keys = jnp.where(valid, keys, pad_key)
            sk, si = relational.sort_with_index(keys)
            return (sk, si, col.rows)

        return self._memo(self._device, (key, column, "sorted_key"), stamp, build)

    def parted_key(self, source: str | Sequence[str], column: str):
        """PARTITIONED build side of a lookup join, for attribute tables
        too large to replicate on every shard (the star-schema limit):
        the key column sorts GLOBALLY on the host, then splits into
        contiguous sorted ranges over the serving mesh — shard ``s``
        holds sorted positions ``[s·Ap/S, (s+1)·Ap/S)``. A probe key can
        therefore bsearch each shard LOCALLY, and its first global match
        lives on exactly one shard: the first shard whose range contains
        the key (claimed via ``key > boundaries[s]``, the previous
        shard's last key — every key on earlier shards is ≤ it).

        Returns ``(sorted_keys [Ap row-sharded], sorted_index [Ap
        row-sharded int32 original rows], boundaries [S row-sharded],
        rows, perm [Ap] host np)`` — ``perm`` lets
        :meth:`parted_scalar` lay value columns out in the same order."""
        import jax

        key = _source_key(source)
        stamp = self._mtimes(key)

        def build():
            data = self.host_table(source)
            host = _require_int32(
                ingest.scalar_column_to_numpy(data.column(column)), column
            ).astype(np.int32)
            rows = host.shape[0]
            n_shards = int(self.mesh.devices.size)
            a_pad = max(ingest.round_up(rows, self._shard_block), self._shard_block)
            keys = np.full(a_pad, np.iinfo(np.int32).max, np.int32)
            keys[:rows] = host
            perm = np.argsort(keys, kind="stable").astype(np.int32)
            sk = keys[perm]
            per = a_pad // n_shards
            bounds = np.full(n_shards, np.iinfo(np.int32).min, np.int32)
            if n_shards > 1:
                bounds[1:] = sk[np.arange(1, n_shards) * per - 1]
            sharding = self._row_sharding(1)
            return (
                jax.device_put(sk, sharding),
                jax.device_put(perm, sharding),
                jax.device_put(bounds, sharding),
                rows,
                perm,
            )

        return self._memo(self._device, (key, column, "parted_key"), stamp, build)

    def parted_scalar(
        self, source: str | Sequence[str], column: str, key_column: str
    ):
        """Scalar column permuted into :meth:`parted_key`'s sorted-key
        order and row-sharded alongside it — a local join hit's sorted
        position gathers its group/value locally, no replication."""
        import jax

        key = _source_key(source)
        stamp = self._mtimes(key)

        def build():
            _, _, _, rows, perm = self.parted_key(source, key_column)
            data = self.host_table(source)
            host = _require_int32(
                ingest.scalar_column_to_numpy(data.column(column)), column
            )
            safe = np.where(perm < rows, perm, 0)
            permuted = np.where(perm < rows, host[safe], 0).astype(host.dtype)
            # jnp canonicalizes 64-bit host dtypes to the device's 32-bit
            import jax.numpy as jnp

            return jax.device_put(jnp.asarray(permuted), self._row_sharding(1))

        return self._memo(
            self._device, (key, column, "parted_scalar", key_column), stamp, build
        )

    def clustered_meta(self, coding: str, source: str | Sequence[str], column: str):
        """Host side of the IVF-clustered layout: ``(perm, offsets)``.

        ``perm`` maps sorted position → original row (stable sort by
        cell id; within a cell, ascending original id; padding rows
        last), ``offsets[c]`` is the first sorted position of cell
        ``c`` (length n_cells+1). Cheap (no device work) so the
        executor can decide gather-vs-scan routing before paying for
        the device arrays."""
        key = _source_key(source)
        paths = self._coded_paths(coding, key, column)
        stamp = self._mtimes(key) + tuple(os.path.getmtime(p) for p in paths)

        def build():
            coded_dev = self.coded_ids(coding, source, column)
            coded_host = np.asarray(coded_dev.data)
            coding_meta = self.coding(coding)
            n_books, k_book, _ = coding_meta["tensor"].shape
            n_cells = int(k_book) ** int(n_books)

            # padding rows (−1) sort to the END via an int-max key
            keys = np.where(coded_host >= 0, coded_host, np.iinfo(np.int32).max)
            perm = np.argsort(keys, kind="stable")
            sorted_keys = keys[perm]
            offsets = np.searchsorted(sorted_keys, np.arange(n_cells + 1))
            return (perm, offsets)

        return self._memo(
            self._device, (key, column, "clustered_meta", coding), stamp, build
        )

    def clustered(self, coding: str, source: str | Sequence[str], column: str):
        """Device side of the IVF-clustered layout: rows sorted by cell
        id. Returns ``(corpus_sorted, coded_sorted, orig_ids_sorted)``
        DeviceColumns. Built lazily — only workloads the router sends
        down the gather path pay the HBM copy
        (fenix_tpu.ops.topk2.topk_ivf_clustered)."""
        key = _source_key(source)
        paths = self._coded_paths(coding, key, column)
        stamp = self._mtimes(key) + tuple(os.path.getmtime(p) for p in paths)

        def build():
            import jax.numpy as jnp

            self.clustered_builds += 1
            full = self.matrix(source, column)
            coded_dev = self.coded_ids(coding, source, column)
            perm, _ = self.clustered_meta(coding, source, column)
            rows = full.rows

            perm_dev = jnp.asarray(perm.astype(np.int32))
            corpus_sorted = ingest.DeviceColumn(data=full.data[perm_dev], rows=rows)
            coded_sorted = ingest.DeviceColumn(data=coded_dev.data[perm_dev], rows=rows)
            # original row id per sorted position (padding → −1) so the
            # kernel can tie-break on ORIGINAL ids directly
            orig = np.where(perm < rows, perm, -1).astype(np.int32)
            orig_ids = ingest.DeviceColumn(data=jnp.asarray(orig), rows=rows)
            return (corpus_sorted, coded_sorted, orig_ids)

        return self._memo(self._device, (key, column, "clustered", coding), stamp, build)

    def clustered_aux(
        self, coding: str, source: str | Sequence[str], column: str, metric: str
    ):
        """(aux_mul, aux_add) in the clustered layout's sorted order."""
        import jax.numpy as jnp

        from fenix_tpu.ops import distance as distance_ops
        from fenix_tpu.ops import topk2

        canonical = distance_ops.canonical_metric(metric)
        key = _source_key(source)
        paths = self._coded_paths(coding, key, column)
        stamp = self._mtimes(key) + tuple(os.path.getmtime(p) for p in paths)

        def build():
            corpus_sorted, _, _ = self.clustered(coding, source, column)
            valid = jnp.arange(corpus_sorted.rows_padded) < corpus_sorted.rows
            return topk2.prepare_aux(corpus_sorted.data, valid, canonical)

        return self._memo(
            self._device, (key, column, "clustered_aux", coding, canonical), stamp, build
        )

    def device_filter_mask(self, source, filt, *, sharded: bool = False):
        """Device-resident ``[N_pad]`` bool mask for a device-evaluable
        predicate, evaluated over HBM-resident scalar columns — the
        filter pushdown path (SURVEY §7 "filter pushdown below the
        matmul"): a filtered search transfers NO per-query host mask;
        after the first build for a (predicate, revision) pair nothing
        crosses the link at all.

        Returns None when a referenced column cannot live on device
        (int64 values outside int32) — callers fall back to the host
        mask. Bounded LRU keyed by the FULL predicate; the compiled
        evaluation is shared across literal values via split_literals.
        """
        key = _source_key(source)
        stamp = self._mtimes(key)
        ckey = (key, bool(sharded), filt.to_json())
        with self._lock:
            hit = self._masks.get(ckey)
            if hit is not None and hit[0] == stamp:
                self._masks.move_to_end(ckey)
                return hit[1]
        try:
            cols = {
                f: self.scalar(source, f, sharded=sharded).data
                for f in sorted(filt.fields())
            }
        except ValueError:
            return None  # int64 out of device range: host fallback
        skeleton, literals = filt.split_literals()
        fn, fields = _mask_eval_fn(skeleton.to_json())
        mask = fn(tuple(cols[f] for f in fields), tuple(literals))
        with self._lock:
            self._masks[ckey] = (stamp, mask)
            self._masks.move_to_end(ckey)
            while len(self._masks) > _MASK_CACHE_LIMIT:
                self._masks.popitem(last=False)
            self.device_mask_builds += 1
        return mask

    def clustered_perm(self, coding: str, source: str | Sequence[str], column: str):
        """Device int32 copy of the clustered layout's permutation
        (sorted position → original row): per-request device masks
        follow rows into the sorted order without a host round-trip."""
        key = _source_key(source)
        paths = self._coded_paths(coding, key, column)
        stamp = self._mtimes(key) + tuple(os.path.getmtime(p) for p in paths)

        def build():
            import jax.numpy as jnp

            perm, _ = self.clustered_meta(coding, source, column)
            return jnp.asarray(perm.astype(np.int32))

        return self._memo(
            self._device, (key, column, "clustered_perm", coding), stamp, build
        )

    def sharded_clustered_perm(
        self, coding: str, source: str | Sequence[str], column: str
    ):
        """Row-sharded LOCAL permutation of the per-shard clustered
        layout (feeds parallel.search.permute_rows_sharded)."""
        import jax

        key = _source_key(source)
        paths = self._coded_paths(coding, key, column)
        stamp = self._mtimes(key) + tuple(os.path.getmtime(p) for p in paths)

        def build():
            perm_local, _, _ = self.sharded_clustered_meta(coding, source, column)
            return jax.device_put(perm_local, self._row_sharding(1))

        return self._memo(
            self._device, (key, column, "sharded_clustered_perm", coding), stamp, build
        )

    def coding(self, name: str) -> coder_mod.Coding:
        path = coder_mod.path_of(self.root, name)
        stamp = os.path.getmtime(path)
        return self._memo(
            self._device, ("coding", name), stamp, lambda: coder_mod.load(self.root, name)
        )

    def snapshot(
        self,
        source: str | Sequence[str],
        column: str,
        coding: str | None = None,
        sharded: bool | None = None,
    ):
        """(host table, device matrix) from the SAME table revision.

        Fetching them separately can straddle a concurrent re-ingest —
        device ids would then be gathered from a different table version
        than was scanned. With ``coding``, the returned host table
        carries the ``__CODED_ID__`` join and the index file mtimes are
        part of the consistency check. Retries until stable.

        ``sharded`` defaults to mesh-presence; pass False for consumers
        whose device pipeline is single-device regardless (the fused
        analytics kernels).

        Returns ``(host table, device matrix, revision stamp)``. The
        stamp is the token the pair was stable under; executors
        re-check it (``snapshot_stamp``) after fetching the OTHER
        device entries (aux, scan copies, coded ids) for a dispatch —
        those memoize under their own stamps, so a mutation landing
        between the snapshot and an aux fetch would otherwise pair a
        newer aux (more valid rows) with an older host table and gather
        out of bounds."""
        from fenix_tpu.io.locks import read_stable
        from fenix_tpu.utils import profiling

        if sharded is None:
            sharded = self.mesh is not None

        def read():
            data = (
                self.coded_table(coding, source, column)
                if coding is not None
                else self.host_table(source)
            )
            return data, self._base_matrix(source, column, sharded)

        with profiling.annotate("fenix.snapshot"):
            (data, matrix), stamp = read_stable(
                lambda: self.snapshot_stamp(source, column, coding),
                read,
                f"table {source!r}",
            )
        return data, matrix, stamp

    def snapshot_stamp(
        self, source: str | Sequence[str], column: str, coding: str | None = None
    ) -> tuple:
        """The revision token :meth:`snapshot` stabilizes under."""
        key = _source_key(source)
        base = self._mtimes(key)
        if coding is None:
            return base
        paths = self._coded_paths(coding, key, column)
        return base + tuple(os.path.getmtime(p) for p in paths)

    def invalidate(self) -> None:
        with self._lock:
            self._host.clear()
            self._device.clear()
            self._masks.clear()
