"""Fault-tolerance utilities: retries, timeouts, RAII.

Rebuild of the reference's scattered resilience helpers (SURVEY.md §5):
``FaultToleranceUtils.retryWithTimeout`` (``core/.../core/utils/FaultToleranceUtils.scala:10-22``),
the exponential-backoff loop around native network init (``TrainUtils.scala:280-296``),
and ``StreamUtilities.using/usingMany`` (``core/.../core/env/StreamUtilities.scala``).
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Any, Callable, Iterable, Optional, Sequence, Tuple, Type

__all__ = ["retry_with_timeout", "retry_with_backoff", "using", "using_many", "run_with_timeout"]

_logger = logging.getLogger("synapseml_tpu_torch.fault")


def run_with_timeout(fn: Callable[[], Any], timeout_s: float) -> Any:
    """Run ``fn`` on a daemon thread, raising TimeoutError after ``timeout_s``.

    On timeout the worker thread is truly abandoned (daemon=True, never joined) — a hung
    ``fn`` neither blocks the caller past the deadline nor prevents interpreter exit.
    """
    box: dict = {}
    done = threading.Event()

    def worker():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised in caller
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    if not done.wait(timeout_s):
        raise TimeoutError(f"timed out after {timeout_s}s")
    if "error" in box:
        raise box["error"]
    return box["value"]


def retry_with_timeout(fn: Callable[[], Any], times: int = 3, timeout_s: float = 60.0) -> Any:
    """Retry ``fn`` up to ``times`` attempts, each bounded by ``timeout_s``."""
    times = max(1, times)  # always run at least once
    last: Optional[BaseException] = None
    for attempt in range(times):
        try:
            return run_with_timeout(fn, timeout_s)
        except Exception as e:  # noqa: BLE001 - deliberate catch-all retry
            last = e
            _logger.warning("attempt %d/%d failed: %s", attempt + 1, times, e)
    raise last  # type: ignore[misc]


def retry_with_backoff(
    fn: Callable[[], Any],
    retries: int = 5,
    initial_delay_s: float = 0.1,
    max_delay_s: float = 10.0,
    backoff: float = 2.0,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    sleep: Callable[[float], None] = time.sleep,
) -> Any:
    """Exponential-backoff retry (reference: LightGBM ``networkInit`` backoff loop)."""
    retries = max(1, retries)  # always run at least once
    delay = initial_delay_s
    last: Optional[BaseException] = None
    for attempt in range(retries):
        try:
            return fn()
        except retry_on as e:
            last = e
            if attempt == retries - 1:
                break
            _logger.warning("retrying after %.2fs (attempt %d/%d): %s", delay, attempt + 1, retries, e)
            sleep(delay)
            delay = min(delay * backoff, max_delay_s)
    raise last  # type: ignore[misc]


@contextlib.contextmanager
def using(resource):
    """RAII helper: closes the resource on exit (``StreamUtilities.using``)."""
    try:
        yield resource
    finally:
        close = getattr(resource, "close", None)
        if close is not None:
            with contextlib.suppress(Exception):
                close()


@contextlib.contextmanager
def using_many(resources: Sequence[Any]):
    try:
        yield resources
    finally:
        for r in resources:
            close = getattr(r, "close", None)
            if close is not None:
                with contextlib.suppress(Exception):
                    close()
