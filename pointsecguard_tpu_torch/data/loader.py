"""Host input pipeline of the trainer (port of
``pointsecguard_tpu/data/loader.py:32-132``): one background thread runs
the numpy sampler, the augmentation and the copy to the device, and
stages ready batches in a bounded queue, so the host pipeline overlaps
the device's step instead of alternating with it; ``stack_batches``
groups them ``--steps_per_call`` deep.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

_SENTINEL = object()


def prefetch(
    iterable: Iterable,
    transform: Callable | None = None,
    *,
    depth: int = 2,
) -> Iterator:
    """Iterate ``iterable`` on a background thread, ``depth`` items ahead.

    Args:
      iterable: the source iterator (e.g. ``sampler.batches(...)``). It is
        consumed entirely on the worker thread, so any RNG it draws from
        keeps the exact sequential order of a plain ``for`` loop.
      transform: optional per-item callable, also run on the worker thread
        (augmentation and the copy to the device belong here, so that
        transfers are in flight before the consumer asks).
      depth: max items staged ahead (``depth <= 0`` disables prefetching
        and iterates inline — same semantics, no thread).

    Yields the (transformed) items in order. Exceptions raised by the
    source or transform re-raise at the consuming ``next()`` call. Breaking
    out early stops the worker promptly (bounded queue + stop flag).
    """
    if depth <= 0:
        for item in iterable:
            yield transform(item) if transform is not None else item
        return

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(entry) -> bool:
        # bounded put, polled so that an abandoned consumer cannot strand
        # the thread on a full queue, and so that an exception is never
        # dropped while the consumer sits in a long device step
        while not stop.is_set():
            try:
                q.put(entry, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if transform is not None:
                    item = transform(item)
                if not put((False, item)):
                    return
            put((False, _SENTINEL))
        except BaseException as e:  # handed to the consumer, which re-raises
            put((True, e))

    t = threading.Thread(target=worker, daemon=True, name="psg-prefetch")
    t.start()
    try:
        while True:
            is_exc, item = q.get()
            if is_exc:
                raise item
            if item is _SENTINEL:
                return
            yield item
    finally:
        stop.set()
        # unblock a worker waiting on a full queue, then reap it
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)


def stack_batches(iterable: Iterable[tuple], k: int) -> Iterator[tuple]:
    """Group consecutive batch tuples into stacks of ``k`` along a new
    leading axis: ``k`` tuples of arrays ``[B, ...]`` → one tuple of
    arrays ``[k, B, ...]`` (JAX `data/loader.py:111-132`). The epoch's
    tail (fewer than ``k`` items) comes one item at a time as
    ``[1, B, ...]`` stacks, so a consumer sees two stack depths only."""
    if k <= 1:
        for item in iterable:
            yield tuple(np.asarray(x)[None] for x in item)
        return
    buf: list[tuple] = []
    for item in iterable:
        buf.append(item)
        if len(buf) == k:
            yield tuple(np.stack(xs) for xs in zip(*buf))
            buf = []
    for item in buf:
        yield tuple(np.asarray(x)[None] for x in item)


def make_batch_put(device: torch.device, depth: int = 2) -> Callable:
    """``(points, labels) numpy → tensors on device``, for ``prefetch``'s
    transform. On a CUDA device the arrays are staged through a ring of
    ``depth + 2`` pinned host buffers and copied without blocking the
    thread; the returned tensors carry the event of their copy, which
    ``wait_batch`` makes the consumer's stream wait for. A ring slot is
    reused only after its copy has finished: the queue holds at most
    ``depth`` batches, the consumer one and the worker one. A slot takes
    new buffers when the arrays' shapes change (a ``stack_batches``
    tail)."""
    if device.type != "cuda":
        def put_cpu(item):
            pts, labels = item
            return (torch.from_numpy(np.ascontiguousarray(pts, np.float32)),
                    torch.from_numpy(np.ascontiguousarray(labels)).long(), None)
        return put_cpu

    ring: list = []
    slots = depth + 2
    stream = torch.cuda.Stream(device)
    turn = [0]

    def put_cuda(item):
        pts, labels = item
        pts = np.ascontiguousarray(pts, np.float32)
        labels = np.ascontiguousarray(labels, np.int64)
        i = turn[0] % slots
        turn[0] += 1
        if len(ring) <= i:
            ring.append(None)
        if ring[i] is not None:
            ring[i][2].synchronize()  # the slot's previous copy has left the buffer
        if ring[i] is None or ring[i][0].shape != pts.shape or ring[i][1].shape != labels.shape:
            ring[i] = (torch.empty(pts.shape, dtype=torch.float32).pin_memory(),
                       torch.empty(labels.shape, dtype=torch.int64).pin_memory(),
                       torch.cuda.Event())
        host_p, host_l, done = ring[i]
        host_p.copy_(torch.from_numpy(pts))
        host_l.copy_(torch.from_numpy(labels))
        with torch.cuda.stream(stream):
            dev_p = host_p.to(device, non_blocking=True)
            dev_l = host_l.to(device, non_blocking=True)
            done.record(stream)
        return dev_p, dev_l, done

    return put_cuda


def wait_batch(batch):
    """The consumer's half of ``make_batch_put``: the current stream waits
    for the batch's copy (no host wait), and the tensors are marked as
    used on it so that their memory is not handed out again early."""
    pts, labels, done = batch
    if done is not None:
        cur = torch.cuda.current_stream(pts.device)
        cur.wait_event(done)
        pts.record_stream(cur)
        labels.record_stream(cur)
    return pts, labels
