"""Pipelined stage execution: double-buffered host-side prefetch.

SURVEY §2's parallelism table row "pipeline parallelism across stages":
overlap depth-consistency / matching / solve stages across a sequence
stream (double-buffered host->device feeds). The reference runs every
stage strictly serially on one thread (AlignmentSeq, Processor.cpp:835-1106).

The device side is already asynchronous (XLA dispatch returns
before execution finishes), so the serial bottleneck is HOST work: disk
ingest (raw/jpg decode), numpy assembly, artifact writes. ``prefetch_map``
runs the producer for item i+1..i+depth on worker threads while the caller
consumes item i — a bounded pipeline that keeps the device fed without
unbounded memory growth. Exceptions propagate at the consuming position,
order is preserved, and the pool tears down cleanly on early exit.

Used by pipeline/ingest.load_sequences (overlap per-directory IO) and
available to any stage loop.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
R = TypeVar("R")


def prefetch_map(fn: Callable[[T], R], items: Iterable[T], *,
                 depth: int = 2) -> Iterator[R]:
    """Yield fn(item) in order, computing up to ``depth`` items ahead on
    background threads (double-buffered for depth=2)."""
    if depth < 1:
        for it in items:
            yield fn(it)
        return
    it = iter(items)
    with ThreadPoolExecutor(max_workers=depth) as pool:
        window: collections.deque = collections.deque()
        try:
            for x in it:
                window.append(pool.submit(fn, x))
                if len(window) > depth:
                    yield window.popleft().result()
            while window:
                yield window.popleft().result()
        finally:
            for f in window:
                f.cancel()


class StagePipeline:
    """Two-stage producer/consumer pipeline: ``producer`` runs on a worker
    thread ``depth`` items ahead; ``consumer`` runs on the caller thread.
    Returns the list of consumer results (order preserved).

    The producer is typically host IO + device-input assembly; the
    consumer dispatches jitted device work — with XLA's async dispatch the
    device stays busy while the next item loads.
    """

    def __init__(self, producer: Callable, consumer: Callable,
                 depth: int = 2):
        self.producer = producer
        self.consumer = consumer
        self.depth = depth

    def run(self, items: Iterable) -> list:
        return [self.consumer(x)
                for x in prefetch_map(self.producer, items,
                                      depth=self.depth)]
