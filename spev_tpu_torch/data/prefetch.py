"""Background-thread batch prefetching (own copy of
``spev_tpu.data.prefetch``).

``prefetch`` runs the producer iterator in a daemon thread with a bounded
queue, so batch N+1 is loaded and collated while step N runs.  Order is
preserved; a producer exception re-raises at the consumer's next pull.  A
consumer that abandons the generator early leaves the producer parked on
the queue until the process ends.  Under a profiler the consumer's wait
for each item is the span ``spev.train.data_wait``.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

from spev_tpu_torch.diag.profiling import span

T = TypeVar("T")

_END = object()


def prefetch(iterable: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Yield ``iterable``'s items in order, produced ``depth`` ahead by a
    background thread.  ``depth <= 0`` returns the iterable's own iterator."""
    if depth <= 0:
        return iter(iterable)

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    err: list = []

    def worker() -> None:
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # re-raised on the consumer side
            err.append(e)
        finally:
            q.put(_END)

    threading.Thread(target=worker, daemon=True, name="spev-prefetch").start()

    def consume() -> Iterator[T]:
        while True:
            with span("spev.train.data_wait"):
                item = q.get()
            if item is _END:
                if err:
                    raise err[0]
                return
            yield item

    return consume()
