"""Background-thread batch prefetching for host-bound loaders.

Copy of ``collie_tpu/data/prefetch.py``.  The whole-epoch engine keeps an
in-memory epoch on the device, but custom loaders train through the
trainer's per-step path, where the host's batch work (reads, negative
sampling) would wait for each device step.  ``PrefetchLoader`` overlaps
them with a producer thread and a small bounded queue (the reference's
analog is ``DataLoader(num_workers>0)``).
"""
import queue
import threading
from typing import Iterator

_SENTINEL = object()


class PrefetchLoader:
    """Wrap any re-iterable batch loader with a producer thread.

    Proxies loader attributes (``num_users`` etc.) so it stands in wherever
    an ``InteractionsDataLoader`` is accepted.  An error in the producer is
    raised in the consumer after the batches it yielded before failing.
    """

    def __init__(self, loader, buffer_size: int = 4):
        self.loader = loader
        self.buffer_size = buffer_size

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.buffer_size)
        error = []

        def producer():
            try:
                for batch in self.loader:
                    q.put(batch)
            except BaseException as exc:  # surface producer failures
                error.append(exc)
            finally:
                q.put(_SENTINEL)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is _SENTINEL:
                    break
                yield batch
            if error:
                raise error[0]
        finally:
            thread.join(timeout=5)
