"""Host-side input pipeline: shuffled batching with background prefetch
(the port's own copy of lr2ppo_tpu/data/pipeline.py: Loader, EvalLoader
and ProcessLoader).

Replaces the reference's DataLoader(num_workers=32) + DistributedSampler
(ppo.py:684-699) with a thread-pool prefetcher feeding static-shape numpy
batches; the trainer moves them to the device (train/common.py:DeviceCtx).
Eval uses shape buckets + masks instead of bs=1 ragged batches, so every
batch of a bucket has one shape.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from lr2ppo_torch.utils import span


def _collate(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    # preallocate-and-assign instead of np.stack: stack/concatenate's
    # fresh-allocation path is pathologically slow for multi-MB batches
    # on this host (measured 1.5-3.7s vs 25ms for a 72MB batch; worse in
    # worker threads), which capped the host pipeline at ~6 samples/s
    out: Dict[str, np.ndarray] = {}
    for k in items[0]:
        first = np.asarray(items[0][k])
        buf = np.empty((len(items),) + first.shape, first.dtype)
        for i, it in enumerate(items):
            buf[i] = it[k]
        out[k] = buf
    return out


def _collate_into(items: List[Dict[str, np.ndarray]],
                  slot: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """_collate writing into (and lazily growing) a reusable buffer set;
    `slot` is owned by the caller's buffer pool."""
    for k in items[0]:
        first = np.asarray(items[0][k])
        shape = (len(items),) + first.shape
        buf = slot.get(k)
        if buf is None or buf.shape != shape or buf.dtype != first.dtype:
            buf = np.empty(shape, first.dtype)
            slot[k] = buf
        for i, it in enumerate(items):
            buf[i] = it[k]
    return dict(slot)


def _next_item(q: "queue.Queue", stop: threading.Event):
    """The producer's next item, or None at its end or once this iteration
    was preempted."""
    while True:
        # stop-aware get: when a NEW iteration preempts this one (sets our
        # stop event), the producer exits without the None sentinel — the
        # iterator must end, not hang
        try:
            item = q.get(timeout=0.1)
        except queue.Empty:
            if stop.is_set():
                return None
            continue
        # preempted: items still in the queue reference reuse_buffers slots
        # the NEW iteration is already rewriting — discard them, never yield
        # stale slots
        return None if stop.is_set() else item


class Loader:
    """Shuffling, fixed-batch loader with double-buffered prefetch.

    drop_last=False pads the final batch by wrapping around (weighting is
    negligible and shapes stay static, which XLA requires).

    ONE active iterator at a time: starting a new iteration preempts the
    previous one (its producer and workers are stopped and joined so no
    stale collation can race the shared buffer pool; the old iterator
    then simply ends).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, num_workers: int = 8,
                 prefetch_depth: int = 2, drop_last: bool = False,
                 reuse_buffers: bool = False,
                 shard: Optional[tuple] = None, shard_chunks: int = 1):
        self.ds = dataset
        self.bs = batch_size
        # shard_chunks > 1: the consumer folds each batch into
        # (shard_chunks, micro, ...) for in-compile grad accumulation
        # (train/pretrain.py _fold) — the process-local slice must then be
        # taken PER CHUNK so local rows reshape to (chunks, micro/world)
        self.shard_chunks = shard_chunks
        # (rank, world): multi-host pods. Every process computes the
        # IDENTICAL global shuffle (same seed+epoch) and materializes only
        # rows [rank*bs/world : (rank+1)*bs/world] of each global batch —
        # the TPU analogue of the reference's per-rank reader stride
        # (tencentpretrain/utils/dataloader.py:32-39, DistributedSampler
        # in ppo.py:684-699). The port passes (dp_rank, dp) under dp
        # (cli/_common.py:pod_shard), None at dp 1.
        if shard is not None:
            rank, world = shard
            assert 0 <= rank < world, shard
            assert batch_size % (world * shard_chunks) == 0, (
                f"batch_size {batch_size} not divisible by process "
                f"count {world} x accum chunks {shard_chunks}")
        self.shard = shard
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.num_workers = num_workers
        self.prefetch_depth = prefetch_depth
        self.drop_last = drop_last
        # recycle collated batch buffers across iterations: fresh multi-MB
        # numpy allocations page-fault at ~100x the reuse cost on some
        # hosts (measured 1.4s vs 5ms for a 72MB batch on the TPU host).
        # OPT-IN because a yielded batch is only valid while it
        # is the most recently dequeued one — consumers that retain
        # batches (the PPO memory buffer) must leave this off.
        self.reuse_buffers = reuse_buffers
        self._pool: List[Dict[str, np.ndarray]] = []
        # the previous __iter__'s (stop_event, executor, producer thread):
        # a new iteration preempts it so no stale worker writes the
        # shared slot pool while the new one collates into it
        self._live = None

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        # propagate: datasets with per-epoch state (dynamic masking,
        # image-shuffle rng) reseed on it
        if hasattr(self.ds, "set_epoch"):
            self.ds.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.ds)
        return n // self.bs if self.drop_last else -(-n // self.bs)

    def _batch_indices(self) -> List[np.ndarray]:
        n = len(self.ds)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        batches = []
        for s in range(0, n, self.bs):
            idx = order[s: s + self.bs]
            if len(idx) < self.bs:
                if self.drop_last:
                    break
                # wrap-around padding, encoded negative (idx - n) so the
                # producer can mark the padded rows (i % n recovers them)
                idx = np.concatenate(
                    [idx, order[: self.bs - len(idx)] - len(self.ds)])
            batches.append(idx)
        if self.shard is not None:
            rank, world = self.shard
            if self.shard_chunks > 1:
                m = self.bs // self.shard_chunks       # rows per chunk
                ml = m // world
                sel = np.concatenate([
                    np.arange(a * m + rank * ml, a * m + (rank + 1) * ml)
                    for a in range(self.shard_chunks)])
                batches = [b[sel] for b in batches]
            else:
                local = self.bs // world
                batches = [b[rank * local: (rank + 1) * local]
                           for b in batches]
        return batches

    def first_batch(self) -> Dict[str, np.ndarray]:
        """One synchronously collated batch in FRESH buffers — for shape
        probing / parameter init. Unlike `next(iter(loader))` it spins up
        no prefetch machinery, so abandoning it leaves no worker racing
        the next iteration for the reuse_buffers slot pool."""
        n = len(self.ds)
        idx = self._batch_indices()[0]
        return _collate([self.ds.get(int(i) % n) for i in idx])

    def _preempt(self) -> None:
        """Stop the previous iteration's producer + workers and wait for
        any running collation to finish, so its slot writes cannot race
        the next iteration's."""
        if self._live is None:
            return
        stop, pool, thread = self._live
        self._live = None
        stop.set()
        try:
            pool.shutdown(wait=True, cancel_futures=True)
        except Exception:
            pass
        thread.join(timeout=5)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        self._preempt()
        batches = self._batch_indices()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        stop = threading.Event()
        self._live = None
        n = len(self.ds)

        def make_batch(idx, slot=None):
            items = [self.ds.get(int(i) % n) for i in idx]
            if slot is None:
                batch = _collate(items)
            else:
                batch = _collate_into(items, slot)
            neg = np.asarray(idx) < 0
            if neg.any() and not self.drop_last:
                # wrap-padded rows in the final batch: mark so eval
                # consumers don't double-count them. Elementwise (not a
                # suffix count): chunk-interleaved shard selection can
                # place wrapped rows mid-array
                batch["_valid"] = ~neg
            else:
                batch.pop("_valid", None)
            return batch

        def producer():
            # bounded in-flight window: q.maxsize only throttles puts,
            # so submitting everything up front would materialize the
            # whole epoch in Future results (hundreds of GB for MovieNet)
            window = self.prefetch_depth + self.num_workers
            # Slot-pool sizing: when batch j is submitted, batch j-window
            # was just enqueued; with a full queue the consumer may still
            # be using batch j-window-prefetch_depth. Batch j writes into
            # the slot of batch j-len(slots), so the pool needs at least
            # window + prefetch_depth + 1 slots (+1 margin) or a worker
            # overwrites the batch the consumer holds.
            slots = [None] * (window + self.prefetch_depth + 2)
            if self.reuse_buffers:
                while len(self._pool) < len(slots):
                    self._pool.append({})
                slots = self._pool
            def put(obj) -> bool:
                # stop-aware put: a preempted producer must not block
                # forever on a full queue nobody drains
                while not stop.is_set():
                    try:
                        q.put(obj, timeout=0.1)
                        return True
                    except queue.Full:
                        continue
                return False

            try:
                # deque + popleft: a completed Future retains its batch
                # result, so a grow-only list would hold every collated
                # batch of the epoch live (tens of GB for a
                # reuse_buffers=False eval epoch)
                from collections import deque

                pending = deque()
                it = iter(batches)
                for k, idx in enumerate(it):
                    pending.append(pool.submit(make_batch, idx,
                                               slots[k % len(slots)]))
                    if len(pending) >= window:
                        break
                i = 0
                for idx in it:
                    if stop.is_set():
                        return
                    if not put(pending.popleft().result()):
                        return
                    pending.append(pool.submit(
                        make_batch, idx,
                        slots[(i + window) % len(slots)]))
                    i += 1
                while pending:
                    if stop.is_set():
                        return
                    if not put(pending.popleft().result()):
                        return
            except Exception as e:  # surface worker errors to the consumer
                put(e)
            finally:
                while not stop.is_set():
                    try:
                        q.put(None, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        self._live = (stop, pool, t)
        try:
            while True:
                with span("data.wait"):
                    item = _next_item(q, stop)
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            try:
                pool.shutdown(wait=False, cancel_futures=True)
            except Exception:
                pass  # interpreter teardown: queue module may be gone


class EvalLoader:
    """Bucketed eval batching: items grouped by padded tag count so XLA
    compiles one program per (bucket, batch) shape; a boolean mask marks
    real tags (NDCG honors it).

    Items larger than the top bucket get a dynamically grown bucket
    (rounded up to a multiple of the growth quantum) — the reference
    evaluates FULL tag lists at bs=1 (ppo.py:620-681), so truncating a
    >top-bucket item would silently change its NDCG@full."""

    GROW_QUANTUM = 32

    def __init__(self, dataset, buckets: Sequence[int],
                 batch_size: int = 8):
        self.ds = dataset
        self.buckets = sorted(buckets)
        self.bs = batch_size

    def _bucket(self, t: int) -> int:
        for b in self.buckets:
            if t <= b:
                return b
        q = self.GROW_QUANTUM
        grown = -(-t // q) * q
        import logging

        logging.getLogger("lr2ppo").info(
            f"EvalLoader: item with {t} tags exceeds top bucket "
            f"{self.buckets[-1]}; growing a {grown}-wide bucket")
        return grown

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        by_bucket: Dict[int, List[int]] = {}
        for i in range(len(self.ds)):
            t = len(self.ds.examples[i][1]) if hasattr(self.ds, "examples") \
                else self.ds.get(i)["text"].shape[0]
            by_bucket.setdefault(self._bucket(t), []).append(i)
        for bucket, ids in sorted(by_bucket.items()):
            for s in range(0, len(ids), self.bs):
                chunk = ids[s: s + self.bs]
                items = [self._pad(self.ds.get(i), bucket) for i in chunk]
                while len(items) < self.bs:   # static batch: repeat last,
                    items.append({**items[-1],  # fully masked out
                                  "mask": np.zeros(bucket, dtype=bool)})
                batch = _collate(items)
                # dataset indices per row (-1 = padding row); bucketing
                # reorders items, so consumers must not assume file order
                batch["_idx"] = np.asarray(
                    chunk + [-1] * (self.bs - len(chunk)), np.int64)
                yield batch

    @staticmethod
    def _pad(item: Dict[str, np.ndarray], bucket: int) -> Dict[str, np.ndarray]:
        t = item["text"].shape[0]
        pad_t = bucket - t
        assert pad_t >= 0, "bucket growth must cover every item"
        out = dict(item)
        if pad_t > 0:
            text_pad = np.zeros((pad_t,) + item["text"].shape[1:],
                                dtype=item["text"].dtype)
            out["text"] = np.concatenate([item["text"], text_pad], axis=0)
            out["tgts"] = np.concatenate(
                [item["tgts"], np.zeros(pad_t, dtype=item["tgts"].dtype)])
        out["mask"] = np.arange(bucket) < t
        return out


def _proc_worker(ds, specs, slot_names, bs, task_q, done_q):
    """Worker process: fill shared-memory batch slots directly from the
    dataset (no multi-MB pickles through a pipe)."""
    from multiprocessing import shared_memory

    if hasattr(ds, "reset_handles"):
        ds.reset_handles()          # h5py handles do not survive fork
    shms, views = [], []
    for names in slot_names:
        shm_map, view_map = {}, {}
        for key, (shape, dtype) in specs.items():
            shm = shared_memory.SharedMemory(name=names[key])
            shm_map[key] = shm
            view_map[key] = np.ndarray((bs,) + shape, dtype, buffer=shm.buf)
        shms.append(shm_map)
        views.append(view_map)
    n = len(ds)
    cur_epoch = None
    while True:
        task = task_q.get()
        if task is None:
            break
        gen, k, slot, idx, epoch = task
        if epoch != cur_epoch and hasattr(ds, "set_epoch"):
            ds.set_epoch(epoch)   # forked workers miss parent set_epoch
            cur_epoch = epoch
        try:
            for r, i in enumerate(idx):
                item = ds.get(int(i) % n)
                for key, v in item.items():
                    views[slot][key][r] = v
            done_q.put((gen, k, slot,
                        int((np.asarray(idx) < 0).sum()), None))
        except Exception as e:  # surface to the parent
            done_q.put((gen, k, slot, 0, f"{type(e).__name__}: {e}"))
    for shm_map in shms:
        for shm in shm_map.values():
            shm.close()


class ProcessLoader(Loader):
    """Process-based prefetcher with shared-memory batch slots.

    The thread Loader tops out near 160 samples/s at real LRMovieNet
    shapes: h5py serializes every HDF5 call behind one global API lock
    and numpy item assembly holds the GIL. Worker PROCESSES sidestep
    both; each worker writes its rows straight into a shared-memory slot.

    Contract: a yielded batch is backed by a shared slot and stays valid
    for the next `HOLDBACK` yields; consumers that retain batches (the
    PPO memory buffer) must copy — `shared_slots = True` signals this.
    """

    shared_slots = True
    HOLDBACK = 2

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, num_workers: int = 4,
                 prefetch_depth: int = 2, drop_last: bool = False,
                 shard: Optional[tuple] = None, shard_chunks: int = 1):
        super().__init__(dataset, batch_size, shuffle, seed,
                         num_workers, prefetch_depth, drop_last,
                         shard=shard, shard_chunks=shard_chunks)
        self._pool = None  # (procs, task_q, done_q, views, finalizer)
        # abandoned-iterator hygiene: dispatched tasks are tagged with a
        # generation; a new __iter__ first drains every outstanding task
        # so no stale worker is still writing the slots it reuses
        self._gen = 0
        self._outstanding = 0

    def _ensure_pool(self):
        if self._pool is not None:
            return
        import multiprocessing as mp
        import weakref
        from multiprocessing import shared_memory

        probe = self.ds.get(0)
        specs = {k: (np.asarray(v).shape, np.asarray(v).dtype)
                 for k, v in probe.items()}
        n_slots = self.num_workers + self.prefetch_depth + self.HOLDBACK + 1
        shms, views, slot_names = [], [], []
        for _ in range(n_slots):
            shm_map, view_map, name_map = {}, {}, {}
            for key, (shape, dtype) in specs.items():
                size = int(self.bs * np.prod(shape, dtype=np.int64)
                           * dtype.itemsize) or 1
                shm = shared_memory.SharedMemory(create=True, size=size)
                shm_map[key] = shm
                name_map[key] = shm.name
                view_map[key] = np.ndarray((self.bs,) + shape, dtype,
                                           buffer=shm.buf)
            shms.append(shm_map)
            views.append(view_map)
            slot_names.append(name_map)

        mctx = mp.get_context("fork")
        # Queue (not SimpleQueue): get(timeout=) lets the consumer
        # detect a hard-dead worker instead of blocking forever on a
        # done entry that will never arrive
        task_q, done_q = mctx.SimpleQueue(), mctx.Queue()
        procs = [mctx.Process(
            target=_proc_worker,
            args=(self.ds, specs, slot_names, self.bs, task_q, done_q),
            daemon=True) for _ in range(self.num_workers)]
        for p in procs:
            p.start()

        def cleanup(procs=procs, task_q=task_q, shms=shms):
            for _ in procs:
                try:
                    task_q.put(None)
                except Exception:
                    pass
            for p in procs:
                p.join(timeout=2)
                if p.is_alive():
                    p.terminate()
            for shm_map in shms:
                for shm in shm_map.values():
                    try:
                        shm.close()
                        shm.unlink()
                    except Exception:
                        pass

        fin = weakref.finalize(self, cleanup)
        self._pool = (procs, task_q, done_q, views, fin, n_slots)
        # slots whose batches were recently yielded and may still be in
        # the consumer's hands; persists across __iter__ calls so the
        # "valid for the next HOLDBACK yields" contract spans epochs
        from collections import deque
        self._holdback = deque()

    DONE_POLL_S = 10.0   # liveness-check period, not a deadline

    def _get_done(self, done_q, procs):
        """done_q.get with worker-liveness checks: a worker that dies
        hard (OOM-kill, segfault in an h5 read) never posts its done
        entry — only Python-level exceptions travel the except branch —
        so a bare get() would hang the trainer forever."""
        import queue as _queue

        while True:
            try:
                return done_q.get(timeout=self.DONE_POLL_S)
            except _queue.Empty:
                dead = [p.pid for p in procs if not p.is_alive()]
                if dead:
                    raise RuntimeError(
                        "ProcessLoader worker(s) died without reporting "
                        f"(pids {dead}) — likely OOM-kill or a segfault "
                        "in a data read") from None

    def close(self) -> None:
        if self._pool is not None:
            self._pool[4]()     # run the finalizer now
            self._pool = None
            # the pool's queues die with it: outstanding tasks can never
            # complete, so a fresh pool must not wait for them
            self._outstanding = 0
            from collections import deque
            self._holdback = deque()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        from collections import deque

        self._ensure_pool()
        _, task_q, done_q, views, _, n_slots = self._pool
        # finish every straggler from an abandoned previous iteration
        # before its slots are re-dispatched
        self._gen += 1
        procs = self._pool[0]
        while self._outstanding:
            self._get_done(done_q, procs)
            self._outstanding -= 1
        batches = self._batch_indices()
        # carry the previous epoch's still-reserved slots: a consumer may
        # hold its last yielded batches across the epoch boundary
        holdback = self._holdback
        free = deque(i for i in range(n_slots) if i not in holdback)
        completed: Dict[int, tuple] = {}
        dispatched = yielded = 0
        while yielded < len(batches):
            while free and dispatched < len(batches):
                task_q.put((self._gen, dispatched, free.popleft(),
                            np.asarray(batches[dispatched]), self.epoch))
                self._outstanding += 1
                dispatched += 1
            with span("data.wait"):
                while yielded not in completed:
                    gen, k, slot, wrapped, err = self._get_done(done_q,
                                                                procs)
                    self._outstanding -= 1
                    if gen != self._gen:
                        continue        # straggler from a preempted run
                    if err is not None:
                        raise RuntimeError(
                            f"ProcessLoader worker failed: {err}")
                    completed[k] = (slot, wrapped)
            slot, wrapped = completed.pop(yielded)
            # slots are sized for the full (global) batch; a sharded
            # loader fills and yields only this process's local rows
            lbs = self.bs // self.shard[1] if self.shard else self.bs
            batch = {k: v[:lbs] for k, v in views[slot].items()}
            if wrapped and not self.drop_last:
                # elementwise from the index array (not a suffix count):
                # chunk-interleaved shard selection can place wrapped
                # (negative) rows mid-array
                batch["_valid"] = np.asarray(batches[yielded]) >= 0
            holdback.append(slot)
            if len(holdback) > self.HOLDBACK:
                free.append(holdback.popleft())
            yielded += 1
            yield batch
        # slots still in holdback stay reserved until the next epoch's
        # first yields, preserving the validity contract across epochs
