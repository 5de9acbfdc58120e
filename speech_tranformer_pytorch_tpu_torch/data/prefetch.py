"""Background prefetch of a batch iterator (counterpart of the JAX
package's ``data/prefetch.py``): a bounded producer thread overlaps audio
reads and padding with the device's work; an error in the producer is
raised again in the consumer. Closing the consumer's generator stops the
producer, which then closes the iterable's iterator (a generator's
``finally`` runs, so a worker pool behind it shuts down)."""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch(iterable: Iterable[T], *, buffer_size: int = 2) -> Iterator[T]:
    """Yield from ``iterable``, produced ``buffer_size`` items ahead by a
    background thread."""
    q: queue.Queue = queue.Queue(maxsize=buffer_size)
    err: list = []
    stop = threading.Event()
    it = iter(iterable)

    def producer():
        try:
            for item in it:
                if stop.is_set():
                    return
                q.put(item)
        except BaseException as e:  # raised again in the consumer
            err.append(e)
        finally:
            try:
                close = getattr(it, "close", None)
                if close is not None:
                    close()
            finally:
                q.put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        # A consumer that stops early: unblock the producer's put and let
        # it see the stop flag, so it drops its batches and exits.
        stop.set()
        while t.is_alive():
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
