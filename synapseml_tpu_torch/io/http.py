"""A plain ``urllib`` HTTP exchange with retries on transient statuses.

Port of what the model repositories need from ``synapseml_tpu/io/clients.py``
and ``io/http_schema.py``: the request and response records, one exchange
(HTTP errors come back as responses, a failed connection as status 0), and
``send_with_retries`` over a backoff schedule that retries only 429, 5xx and
connection errors, so a 404 fails at once.
"""

from __future__ import annotations

import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

__all__ = ["HTTPRequestData", "HTTPResponseData", "send_request", "send_with_retries",
           "DEFAULT_BACKOFFS_MS", "RETRY_CODES"]

DEFAULT_BACKOFFS_MS = (100, 500, 1000)
RETRY_CODES = frozenset({429, 500, 502, 503, 504})


@dataclass
class HTTPRequestData:
    url: str
    method: str = "GET"
    headers: Dict[str, str] = field(default_factory=dict)
    entity: Optional[bytes] = None


@dataclass
class HTTPResponseData:
    status_code: int
    reason: str = ""
    headers: Dict[str, str] = field(default_factory=dict)
    entity: Optional[bytes] = None

    @property
    def text(self) -> str:
        return self.entity.decode("utf-8", "replace") if self.entity else ""


def send_request(req: HTTPRequestData, timeout: float = 60.0) -> HTTPResponseData:
    """One HTTP exchange."""
    r = urllib.request.Request(req.url, data=req.entity, method=req.method,
                               headers=dict(req.headers))
    try:
        with urllib.request.urlopen(r, timeout=timeout) as resp:
            return HTTPResponseData(status_code=resp.status, reason=resp.reason or "",
                                    headers=dict(resp.headers.items()), entity=resp.read())
    except urllib.error.HTTPError as e:
        return HTTPResponseData(status_code=e.code, reason=str(e.reason),
                                headers=dict(e.headers.items()) if e.headers else {},
                                entity=e.read() if hasattr(e, "read") else None)
    except (urllib.error.URLError, OSError) as e:
        return HTTPResponseData(status_code=0, reason=f"connection error: {e}")


def send_with_retries(req: HTTPRequestData, timeout: float = 60.0,
                      backoffs_ms: Sequence[int] = DEFAULT_BACKOFFS_MS) -> HTTPResponseData:
    """Retry retryable statuses through the backoff schedule."""
    resp = send_request(req, timeout)
    for backoff in backoffs_ms:
        if resp.status_code not in RETRY_CODES and resp.status_code != 0:
            return resp
        time.sleep(backoff / 1000.0)
        resp = send_request(req, timeout)
    return resp
