"""Background-thread iterator prefetching (a copy of the JAX package's
``data/prefetch.py``).

Overlaps host-side frame decode (``cv2.VideoCapture.read`` releases the
GIL) with device work: the CLI video paths feed
``SimpleHRNet.predict_stream`` through it, so the card does not wait on
video decode.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar('T')

_SENTINEL = object()


def prefetch_iter(it: Iterable[T], depth: int = 4) -> Iterator[T]:
    """Run ``it`` in a daemon thread, buffering up to ``depth`` items; an
    exception of ``it`` is raised here, in order."""
    q: 'queue.Queue' = queue.Queue(maxsize=depth)

    def producer():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:
            q.put(('__error__', e))
            return
        q.put(_SENTINEL)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            return
        if isinstance(item, tuple) and len(item) == 2 and \
                item[0] == '__error__':
            raise item[1]
        yield item
