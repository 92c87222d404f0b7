"""Decode-on-demand parameter paging over a ``.ceazs`` checkpoint stream
(the port of ``src/repro/serve/paging.py``).

The serving-side analog of the paper's claim that compression speeds up
I/O end to end: the checkpoint leaf stream stays the storage and memory
format, and layers decode on first touch through the batched decode
path —

    read_key (O(1) footer-index seek)  -> grouped decode on the card
      -> serving-dtype cast (host)     -> placement on the card
      -> byte-budgeted LRU decoded-layer cache

so startup cost is proportional to the layers actually touched, and the
steady state holds the compressed stream plus at most ``cache_bytes`` of
decoded leaves.

Hot swap: ``swap(new_stream)`` opens the new stream as a new GENERATION,
optionally warms its layers into the cache while readers still page the
old one, then flips the current-generation pointer atomically. A
:meth:`PagedParamStore.pin` handle resolves every key against the
generation captured at pin time, so a decode step never observes a
mixed-generation tree. Old generations stay readable until their last
pin releases, then their reader closes and their cache entries drop.

Over a rank mesh (one process a position) every rank opens its own store
and keeps its PARAM_RULES shard of each leaf it pages in; the LRU budget
counts those shard-sized bytes. ``pin`` and ``swap`` are then collective
over the mesh's ranks, every rank calling them in the same order (pins
from one thread a rank): a swap opens and warms the new stream on every
rank, agrees that all succeeded, and stages the generation; each pin
agrees on the newest generation every rank has staged and flips to it
first. So a pin taken after a swap returned, on any rank, sees the new
generation, one taken before keeps the old one on every rank, and no
step mixes generations across ranks, even with the swap on a thread of
its own (its agreement runs on a process group of its own).

Observability: ``serve.page``/``serve.swap`` spans,
``ceaz_page_{hits,misses,evictions}_total`` counters and the
``ceaz_page_cache_bytes`` resident gauge.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..checkpoint.ckpt import _unflatten_like
from ..core.ceaz import CEAZCompressed
from ..io import engine as E
from ..obs import metrics as om
from ..obs import trace as ot
from ..runtime.fused import target_device
from ..runtime.sharding import (ShardingPlan, is_rank_plan, leaf_sharding,
                                place, plan_device)

__all__ = ["PagedParamStore", "PinnedParams"]


class _Generation:
    """One open stream epoch: reader + decode facade + refcount.

    ``refs`` counts the store's own reference plus every live pin; the
    reader closes when the count hits zero AND the generation is no
    longer current. ``io_lock`` serializes seeks/reads on the reader's
    single file handle (decode itself runs outside the lock)."""

    __slots__ = ("id", "path", "reader", "comp", "bank", "refs",
                 "io_lock")

    def __init__(self, gen_id: int, path: str, reader: E.StreamReader,
                 comp, bank):
        self.id = gen_id
        self.path = path
        self.reader = reader
        self.comp = comp
        self.bank = bank
        self.refs = 1                   # the store's own reference
        self.io_lock = threading.Lock()


class PinnedParams:
    """A generation-consistent read handle (the read barrier).

    Every lookup resolves against the generation captured when the pin
    was taken, so a forward pass that pages layer-by-layer while a
    ``swap`` lands mid-pass still sees ONE stream end to end. Use as a
    context manager (or call :meth:`release`); the pinned generation's
    reader stays open until the last pin releases."""

    def __init__(self, store: "PagedParamStore", gen: _Generation):
        self._store = store
        self._gen = gen
        self._released = False

    @property
    def generation(self) -> int:
        """The stream epoch this pin resolves every key against."""
        return self._gen.id

    def keys(self) -> List[str]:
        """Servable record keys of the pinned generation, commit order."""
        return self._store._servable_keys(self._gen)

    def get(self, key: str):
        """One decoded, cast, device-placed leaf (cache hit or page-in)."""
        return self.get_many([key])[key]

    def get_many(self, keys: Sequence[str]) -> Dict[str, Any]:
        """Decoded leaves for `keys`; misses page in as grouped fused
        decode passes. Returns {key: placed array}."""
        if self._released:
            raise RuntimeError("pin already released")
        return self._store._get_many(self._gen, list(keys))

    def params(self, strip_prefix: bool = True):
        """The full servable tree (pages in every missing layer).

        With `strip_prefix`, the store's key prefix (e.g. ``params/``)
        is removed before the tree is rebuilt, so the result has the
        exact structure serving code expects."""
        keys = self.keys()
        leaves = self.get_many(keys)
        pre = self._store._prefix
        flat = {}
        for k in keys:
            name = k[len(pre):] if (strip_prefix and pre
                                    and k.startswith(pre)) else k
            flat[name] = leaves[k]
        return _unflatten_like(flat, None)

    def release(self):
        if not self._released:
            self._released = True
            self._store._release(self._gen)

    def __enter__(self) -> "PinnedParams":
        return self

    def __exit__(self, *exc):
        self.release()


class PagedParamStore:
    """Compressed-resident parameter store with decode-on-demand paging.

    Args:
      path: the ``.ceazs`` stream to serve from (a checkpoint
        ``leaves.ceazs`` — fully validated at open).
      plan: serve-mesh sharding plan; decoded leaves are placed by their
        PARAM_RULES :func:`leaf_sharding` as they decode: whole on the one
        device of a logical mesh, the rank's shard on a rank mesh (module
        docstring); one process cannot drive a mesh whose positions name
        several devices (ValueError at placement). With ``plan=None``
        (or a mesh-less plan) leaves land on `device`.
      dtype: torch dtype float leaves are cast to on the host BEFORE
        placement (``torch.bfloat16`` by default), so peak device memory
        during a page-in is the serving footprint, never f32+bf16.
        ``None`` disables the cast.
      cache_bytes: decoded-layer LRU budget (placed bytes). The budget
        is strict: an entry larger than the whole budget is evicted
        immediately after being handed out.
      comp: decode facade for ``ceaz`` records; defaults to the stream's
        self-configured fused facade (footer ``block_size`` + codebook
        bank).
      group: records per batched fused decode pass on a page-in.
      prefix: key prefix of the servable subtree (e.g. ``"params/"`` for
        checkpoint streams that also carry optimizer state); ``None``
        serves every record.
      device: where leaves land without a mesh, and where the default
        facade decodes (the card unless the caller asks for the CPU;
        RuntimeError for ``'cuda'`` without a card); a rank's own device
        on a rank mesh.

    Raises:
      StreamCorruptionError: from open/swap on any validation failure
        (including duplicate record keys — paging is key-addressed).
    """

    def __init__(self, path: str, *, plan: Optional[ShardingPlan] = None,
                 dtype=torch.bfloat16, cache_bytes: int = 256 << 20,
                 comp=None, group: int = 8,
                 prefix: Optional[str] = None, device="cuda"):
        self._plan = plan
        self._dtype = dtype
        if is_rank_plan(plan):             # each rank decodes on its own
            device = plan.mesh.local_device
        self._device = target_device(device)
        self._budget = int(cache_bytes)
        self._group = max(1, group)
        self._prefix = prefix or ""
        self._lock = threading.Lock()
        self._closed = False
        self._next_gen = 0
        # (gen_id, key) -> (placed array, nbytes); front = LRU victim
        self._cache: "OrderedDict[Tuple[int, str], Tuple[Any, int]]" = \
            OrderedDict()
        self._bytes = 0
        self._live: Dict[int, _Generation] = {}
        # over a rank mesh: the groups pins and swaps agree on, and the
        # generations swapped in but not yet flipped to, oldest first
        self._pins = self._swaps = None
        self._staged: List[_Generation] = []
        if is_rank_plan(plan):
            from ..runtime.dist import RankGroup
            import torch.distributed as dist
            mesh = plan.mesh
            self._pins = mesh.group(mesh.axis_names)
            ranks = tuple(int(r) for r in mesh.ranks.flat)
            self._swaps = RankGroup((dist.new_group(list(ranks)),), ranks,
                                    self._pins.index)
        self._gen = self._open_generation(path, comp)

    # -- generation lifecycle ------------------------------------------------
    def _open_generation(self, path: str, comp) -> _Generation:
        reader = E.StreamReader(path)       # full index validation
        try:
            bank = E.resolve_stream_bank(reader)
            if comp is None:
                comp = E.default_stream_comp(reader, bank, self._device)
        except BaseException:
            reader.close()
            raise
        with self._lock:
            gen = _Generation(self._next_gen, path, reader, comp, bank)
            self._next_gen += 1
            self._live[gen.id] = gen
        return gen

    def _release(self, gen: _Generation):
        with self._lock:
            gen.refs -= 1
            dead = (gen.refs == 0 and gen not in self._staged
                    and (gen is not self._gen or self._closed))
            if dead:
                self._live.pop(gen.id, None)
                self._drop_generation_cache_locked(gen.id)
        if dead:
            gen.reader.close()

    def _drop_generation_cache_locked(self, gen_id: int):
        for ck in [ck for ck in self._cache if ck[0] == gen_id]:
            _, nb = self._cache.pop(ck)
            self._bytes -= nb
        om.set_gauge(om.PAGE_CACHE_BYTES, self._bytes)

    def pin(self) -> PinnedParams:
        """Take a generation-consistent read handle (see
        :class:`PinnedParams`). Pins taken before a ``swap`` keep
        resolving against the old stream until released. Collective over
        a rank mesh (module docstring)."""
        if self._pins is not None:
            self._agree_on_generation()
        with self._lock:
            if self._closed:
                raise RuntimeError("PagedParamStore is closed")
            gen = self._gen
            gen.refs += 1
        return PinnedParams(self, gen)

    def _agree_on_generation(self):
        """Flip, in order, to every staged generation that every rank has
        staged (the ranks number their generations alike)."""
        from ..runtime.dist import all_gather_object
        with self._lock:
            newest = self._staged[-1].id if self._staged else self._gen.id
        agreed = min(all_gather_object(newest, self._pins))
        olds = []
        with self._lock:
            while self._staged and self._staged[0].id <= agreed:
                olds.append(self._gen)
                self._gen = self._staged.pop(0)
        for old in olds:
            self._release(old)              # store's ref on the old epoch

    def swap(self, path: str, *, comp=None,
             warm: Any = True) -> int:
        """Hot-swap to a new stream with zero reader downtime.

        The new stream opens (and fully validates) as a fresh
        generation; with `warm`, its layers decode into the cache
        layer-by-layer WHILE concurrent readers still page the old
        generation (`warm=True` warms every servable key; an iterable
        warms exactly those keys; `False` skips warming). Only then does
        the current-generation pointer flip — one atomic assignment, so
        a pin sees entirely-old or entirely-new, never a mix. The old
        generation's reader closes when its last pin releases.

        Returns the new generation id.

        Over a rank mesh every rank calls it (collective; module
        docstring): when all ranks opened and warmed their stream, the
        generation is staged and the next pin on every rank flips to it;
        if any rank failed, every rank drops its new generation and
        raises."""
        with ot.span("serve.swap", path=path, warm=bool(warm)):
            new, failed = None, None
            try:
                new = self._open_generation(path, comp)
                if warm is True:
                    warm_keys = self._servable_keys(new)
                elif warm:
                    warm_keys = list(warm)
                else:
                    warm_keys = []
                # warm in page-in-sized slices: the budget's LRU keeps
                # displacing cold old-generation entries as new layers
                # land, readers never block on the bulk decode
                for s in range(0, len(warm_keys), self._group):
                    self._get_many(new, warm_keys[s:s + self._group])
            except BaseException as e:      # raised below, after the
                failed = e                  # ranks agree
            if self._swaps is not None:
                from ..runtime.dist import all_gather_object
                got = all_gather_object((failed is None, self._next_gen),
                                        self._swaps)
                with self._lock:            # ids stay alike on every rank
                    self._next_gen = max(n for _, n in got)
                bad = [r for r, (ok, _) in enumerate(got) if not ok]
                if bad and failed is None:
                    failed = RuntimeError(f"swap failed on ranks {bad}")
            if failed is not None:
                if new is not None:
                    self._release(new)      # drop the store ref: closes
                raise failed
            with self._lock:
                if self._closed:
                    raise RuntimeError("PagedParamStore is closed")
                if self._swaps is not None:
                    self._staged.append(new)
                    return new.id
                old, self._gen = self._gen, new
        self._release(old)                  # store's ref on the old epoch
        return new.id

    def close(self):
        """Release the store's generation reference; readers holding
        pins keep their generation alive until they release."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            gen = self._gen
            staged, self._staged = self._staged, []
        for g in [gen] + staged:
            self._release(g)

    def __enter__(self) -> "PagedParamStore":
        return self

    def __exit__(self, *exc):
        self.close()

    # -- introspection -------------------------------------------------------
    @property
    def generation(self) -> int:
        return self._gen.id

    @property
    def n_generations(self) -> int:
        """Live stream epochs (current + any kept alive by pins)."""
        with self._lock:
            return len(self._live)

    @property
    def cache_resident_bytes(self) -> int:
        return self._bytes

    @property
    def cache_budget_bytes(self) -> int:
        return self._budget

    @property
    def meta(self) -> Dict:
        return self._gen.reader.meta

    def keys(self) -> List[str]:
        """Servable keys of the CURRENT generation (use a pin for
        swap-consistent enumeration + reads)."""
        return self._servable_keys(self._gen)

    def _servable_keys(self, gen: _Generation) -> List[str]:
        return [r["key"] for r in gen.reader.records
                if not self._prefix
                or str(r["key"]).startswith(self._prefix)]

    # -- read path -----------------------------------------------------------
    def _get_many(self, gen: _Generation,
                  keys: List[str]) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        missing: List[str] = []
        with self._lock:
            for k in keys:
                if k in out or k in missing:
                    continue
                hit = self._cache.get((gen.id, k))
                if hit is not None:
                    self._cache.move_to_end((gen.id, k))
                    out[k] = hit[0]
                else:
                    missing.append(k)
        if out:
            om.add(om.PAGE_HITS, len(out))
        if missing:
            out.update(self._page_in(gen, missing))
        return out

    def _page_in(self, gen: _Generation,
                 keys: List[str]) -> Dict[str, Any]:
        """Decode `keys` from the stream: grouped fused decode passes,
        serving-dtype cast, sharded placement, LRU insertion."""
        om.add(om.PAGE_MISSES, len(keys))
        out: Dict[str, Any] = {}
        with ot.span("serve.page", gen=gen.id, n=len(keys)):
            # read in seq order (one forward sweep of the file), decode
            # in caller grouping
            order = sorted(keys, key=gen.reader.seq_of)
            for s in range(0, len(order), self._group):
                grp = order[s:s + self._group]
                with gen.io_lock:       # one file handle per generation
                    pairs = [(gen.reader.records[gen.reader.seq_of(k)],
                              gen.reader.read_key(k)) for k in grp]
                for k, (rec, arr) in zip(grp, self._decode_group(gen,
                                                                 pairs)):
                    placed = self._place(k, arr)
                    self._insert(gen, k, placed)
                    out[k] = placed
        return out

    def _decode_group(self, gen: _Generation,
                      pairs: List[tuple]) -> List[tuple]:
        """One batched fused decode pass over the group's ceaz records
        (mirrors the read engine's group stage; non-ceaz records pass
        through as the arrays their codec produced)."""
        idx = [i for i, (_, obj) in enumerate(pairs)
               if isinstance(obj, CEAZCompressed)]
        for i in idx:
            E.check_bank_record(pairs[i][0], pairs[i][1])
        if idx:
            dec = gen.comp.decompress_batch([pairs[i][1] for i in idx])
            for i, arr in zip(idx, dec):
                rec = pairs[i][0]
                if "dtype" in rec and "shape" in rec:
                    arr = np.asarray(arr).astype(
                        np.dtype(rec["dtype"])).reshape(rec["shape"])
                pairs[i] = (rec, arr)
        return pairs

    def _place(self, key: str, arr):
        """Serving-dtype cast (on the host, before placement), then the
        leaf on its PARAM_RULES sharding's device, or on the store's
        device without a mesh."""
        if isinstance(arr, (bytes, bytearray)):
            return arr                      # raw records pass through
        t = torch.from_numpy(np.asarray(arr, order="C")) \
            if isinstance(arr, np.ndarray) else arr
        if (self._dtype is not None and t.dtype != self._dtype
                and t.is_floating_point()):
            t = t.to(self._dtype)
        if self._plan is not None and self._plan.mesh is not None:
            plan_device(self._plan, "the pager's placement")
            return place(t, leaf_sharding(key, tuple(t.shape), self._plan))
        return t.to(self._device)

    def _insert(self, gen: _Generation, key: str, placed):
        nb = int(getattr(placed, "nbytes", 0))
        with self._lock:
            ck = (gen.id, key)
            old = self._cache.pop(ck, None)
            if old is not None:             # concurrent page-in of one key
                self._bytes -= old[1]
            self._cache[ck] = (placed, nb)
            self._bytes += nb
            # strict budget: evict from the cold end until under budget
            # (a single leaf larger than the budget evicts itself — the
            # caller still holds the decoded array, the cache just
            # refuses to retain it)
            while self._bytes > self._budget and self._cache:
                _, (_, enb) = self._cache.popitem(last=False)
                self._bytes -= enb
                om.add(om.PAGE_EVICTIONS)
            om.set_gauge(om.PAGE_CACHE_BYTES, self._bytes)
