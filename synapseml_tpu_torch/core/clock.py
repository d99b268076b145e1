"""Timing utilities: StopWatch + async bounded-concurrency helpers.

Rebuild of ``core/.../core/utils/StopWatch.scala`` (phase timing used by VW training
diagnostics, ``VowpalWabbitBase.scala:292-327``) and ``AsyncUtils.bufferedAwait``
(``core/.../core/utils/AsyncUtils.scala`` — the backbone of the async HTTP client).
"""

from __future__ import annotations

import concurrent.futures
import time
from typing import Any, Callable, Iterable, Iterator, List, Optional, TypeVar

__all__ = ["StopWatch", "buffered_map"]

T = TypeVar("T")
R = TypeVar("R")


class StopWatch:
    """Accumulating nanosecond stopwatch usable as a context manager.

    >>> sw = StopWatch()
    >>> with sw.measure():
    ...     pass
    >>> sw.elapsed_ns >= 0
    True
    """

    def __init__(self):
        self.elapsed_ns = 0
        self._start: Optional[int] = None

    def start(self) -> None:
        self._start = time.perf_counter_ns()

    def stop(self) -> None:
        if self._start is None:
            raise RuntimeError("StopWatch not started")
        self.elapsed_ns += time.perf_counter_ns() - self._start
        self._start = None

    def restart(self) -> None:
        self.elapsed_ns = 0
        self.start()

    def measure(self):
        sw = self

        class _Ctx:
            def __enter__(self):
                sw.start()
                return sw

            def __exit__(self, *exc):
                sw.stop()
                return False

        return _Ctx()

    @property
    def elapsed_s(self) -> float:
        return self.elapsed_ns / 1e9


def buffered_map(
    fn: Callable[[T], R],
    items: Iterable[T],
    concurrency: int = 8,
    timeout_s: Optional[float] = None,
) -> Iterator[R]:
    """Apply ``fn`` over ``items`` with at most ``concurrency`` in flight, yielding
    results *in input order* as they complete (``AsyncUtils.bufferedAwait``).

    Unlike ``ThreadPoolExecutor.map``, submission is throttled: at most ``concurrency``
    futures exist at once, so an unbounded input stream doesn't queue unboundedly.
    """
    import collections

    it = iter(items)
    pending: "collections.deque[concurrent.futures.Future]" = collections.deque()
    with concurrent.futures.ThreadPoolExecutor(max_workers=concurrency) as ex:
        try:
            while True:
                while len(pending) < concurrency:
                    try:
                        pending.append(ex.submit(fn, next(it)))
                    except StopIteration:
                        break
                if not pending:
                    break
                yield pending.popleft().result(timeout=timeout_s)
        finally:
            for f in pending:
                f.cancel()
