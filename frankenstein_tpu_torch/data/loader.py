"""Prefetching host loader (``frankenstein_tpu/data/loader.py``): overlaps
batch assembly and the host-to-device copy with the training step.

``prefetch`` and ``stack_steps`` are the JAX package's; ``to_device`` copies
each batch through pinned host memory with ``non_blocking=True`` to an
explicit device, so composed inside ``prefetch`` the copy of batch N+1 is
queued while batch N computes.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch


def prefetch(iterator: Iterator, buffer_size: int = 2) -> Iterator:
    """Run ``iterator`` in a daemon thread, keeping ``buffer_size`` batches
    ready. Exceptions propagate to the consumer; closing the returned
    generator stops the thread (an infinite iterator would otherwise keep
    it, and its staged batches, alive)."""
    q: queue.Queue = queue.Queue(maxsize=buffer_size)
    stop = threading.Event()
    _END = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for item in iterator:
                if not put(item):
                    return
        except BaseException as e:  # propagate into the consumer
            put(e)
            return
        put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join()


def stack_steps(iterator: Iterator, k: int) -> Iterator:
    """Group ``k`` consecutive host batches (tuples of arrays) into one
    step-stacked batch: every array gains a leading [k] axis. A trailing
    partial group is dropped, mirroring drop_last batching."""
    buf = []
    for item in iterator:
        buf.append(item)
        if len(buf) == k:
            yield tuple(np.stack(xs) for xs in zip(*buf))
            buf = []


def to_device(iterator: Iterator, device) -> Iterator:
    """Map each batch (a tuple of numpy arrays) to tensors on ``device``:
    pinned host memory, then a non-blocking copy (a plain copy on the
    CPU)."""
    device = torch.device(device)
    pin = device.type == "cuda"
    for item in iterator:
        out = []
        for a in item:
            t = torch.from_numpy(np.ascontiguousarray(a))
            if pin:
                t = t.pin_memory()
            out.append(t.to(device, non_blocking=pin))
        yield tuple(out)
