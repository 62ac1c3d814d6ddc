"""The port's HTTP client for the data plane: its copy of
``kubetorch_tpu/data_store/netpool.py``, on the standard library.

The JAX package's client rides ``requests``; the port's speaks the same
wire with ``http.client``: one keep-alive connection per thread and host
(:func:`session`), the same paths, headers and status handling. What it
keeps, under the JAX names and environment:

- :func:`store_concurrency` (``KT_STORE_CONCURRENCY``, default 8 capped at
  the host's CPUs), :func:`store_timeout` (``KT_STORE_TIMEOUT_S``),
  :func:`urlkey`, :func:`map_concurrent` over one shared executor;
- the ``/kv/diff`` body codings (``zstd`` when the ``zstandard`` module
  imports, ``zlib`` otherwise);
- :func:`request`, the resilient request every store op rides: the
  retryable statuses (502/503/504) with ``Retry-After``, transport errors
  retried, an opt-in per-host circuit breaker
  (``KT_STORE_BREAKER_THRESHOLD``, ``KT_STORE_BREAKER_COOLDOWN_S``), a
  ``store.request`` span, and a 507 raised as a typed ``StoreFullError``
  rebuilt from the server's body.

Bodies stream both ways, as ktsync's do in the JAX package: a
``data_factory`` gives each attempt a fresh body (an open file streams
from disk and is reopened on a retry, since a consumed file cannot be
sent again), and ``stream=True`` hands back a 200 whose body the caller
reads in chunks (:meth:`StreamedResponse.iter_content`), so a transfer
holds O(chunk) of memory per worker.

A transport failure raises one of :data:`TRANSPORT_ERRORS` (``OSError``,
which holds refused and reset connections and timeouts, and
``http.client.HTTPException``); callers catch that where the JAX package
catches ``requests.RequestException``. Left out: the ``KT_CHAOS``
partition verb, a fault-injection hook of the JAX package's tests.
"""

from __future__ import annotations

import http.client
import json as _json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, List, Optional, TypeVar
from urllib.parse import quote, urlencode, urlsplit

from .. import telemetry
from ..exceptions import StoreFullError, rehydrate_exception
from ..resilience import (RETRYABLE_STATUSES, CircuitBreaker,
                          retry_after_seconds, store_policy)

T = TypeVar("T")
R = TypeVar("R")

DEFAULT_CONCURRENCY = 8
DEFAULT_TIMEOUT_S = 600.0
COMPRESS_MIN_BYTES = 1024

TRANSPORT_ERRORS = (OSError, http.client.HTTPException)


def _zstd():
    try:
        import zstandard
        return zstandard
    except ImportError:
        return None


def offered_codings() -> str:
    """The ``Accept-Encoding`` value this client offers."""
    return "zstd, zlib" if _zstd() is not None else "zlib"


def best_coding(accept: Optional[str]) -> Optional[str]:
    """Pick the best body coding both sides speak, or None."""
    tokens = {t.split(";")[0].strip().lower()
              for t in (accept or "").split(",")}
    if "zstd" in tokens and _zstd() is not None:
        return "zstd"
    if "zlib" in tokens:
        return "zlib"
    return None


def compress_body(data: bytes, coding: str) -> bytes:
    if coding == "zstd":
        return _zstd().ZstdCompressor().compress(data)
    if coding == "zlib":
        import zlib
        return zlib.compress(data, level=3)
    raise ValueError(f"unknown body coding {coding!r}")


def decompress_body(data: bytes, coding: Optional[str]) -> bytes:
    if not coding:
        return data
    if coding == "zstd":
        z = _zstd()
        if z is None:
            raise ValueError("zstd body but no zstandard module")
        return z.ZstdDecompressor().decompress(data)
    if coding == "zlib":
        import zlib
        return zlib.decompress(data)
    raise ValueError(f"unknown body coding {coding!r}")


def urlkey(key: str) -> str:
    """Percent-encode a store key for a URL path, keeping ``/`` as the
    separator: the server decodes exactly once, so a key with a literal
    ``%`` or space round-trips."""
    return quote(key, safe="/")


def _host_cpus() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def store_concurrency() -> int:
    """Data-plane fan-out width: ``KT_STORE_CONCURRENCY``, else 8 capped at
    the host's CPU count."""
    raw = os.environ.get("KT_STORE_CONCURRENCY")
    if raw:
        try:
            return max(1, int(raw))
        except ValueError:
            pass
    return min(DEFAULT_CONCURRENCY, _host_cpus())


def store_timeout(default: float = DEFAULT_TIMEOUT_S) -> float:
    """Per-request timeout. ``KT_STORE_TIMEOUT_S`` overrides every hardcoded
    default uniformly (bulk transfers pass 600, control calls pass 60)."""
    try:
        return float(os.environ.get("KT_STORE_TIMEOUT_S", default))
    except (TypeError, ValueError):
        return default


# ---------------------------------------------------------------------------
# The per-thread session
# ---------------------------------------------------------------------------


class Response:
    """What a request returns: ``status_code``, ``headers`` (read
    case-insensitively), the whole body as ``content``."""

    __slots__ = ("status_code", "headers", "content")

    def __init__(self, status_code: int, headers, content: bytes):
        self.status_code = status_code
        self.headers = headers
        self.content = content

    def json(self):
        return _json.loads(self.content)

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", "replace")


class StreamedResponse:
    """A 200 whose body is still on the wire (``request(stream=True)``):
    read it once, through :meth:`iter_content` or ``content``. Its
    connection serves the thread's next request only once the body is
    read to its end; :meth:`close` drops a connection left mid-body."""

    def __init__(self, status_code: int, headers, raw, conn):
        self.status_code = status_code
        self.headers = headers
        self._raw = raw
        self._conn = conn

    def iter_content(self, chunk_size: int = 1 << 20):
        """The body in chunks of at most ``chunk_size`` bytes."""
        try:
            while True:
                block = self._raw.read(chunk_size)
                if not block:
                    break
                yield block
        finally:
            self.close()

    @property
    def content(self) -> bytes:
        return b"".join(self.iter_content())

    def json(self):
        return _json.loads(self.content)

    def close(self) -> None:
        if self._conn is None:
            return
        if not self._raw.isclosed() or self._raw.will_close:
            self._conn.close()
        self._conn = None


def _body_length(body) -> Optional[int]:
    """Bytes left in a file body (sent with ``Content-Length``, as
    ``requests`` sends a file), None when it is not a regular file."""
    try:
        return os.fstat(body.fileno()).st_size - body.tell()
    except (AttributeError, OSError, ValueError):
        return None


class Session:
    """Keep-alive connections of one thread, one per (scheme, host).

    ``request(method, url, data=, json=, headers=, params=, timeout=,
    data_factory=, stream=)`` sends one request and reads the whole
    response, or with ``stream=True`` returns a 200 as a
    :class:`StreamedResponse` (any other status is read whole). A request
    that fails on a connection kept from an earlier one (the server closed
    it while idle) is sent once more on a fresh connection, its body made
    again by ``data_factory`` when one is given; any other failure
    raises."""

    def __init__(self):
        self._conns: Dict[tuple, http.client.HTTPConnection] = {}

    def _conn(self, scheme: str, netloc: str, timeout: Optional[float]):
        conn = self._conns.get((scheme, netloc))
        if conn is None:
            cls = (http.client.HTTPSConnection if scheme == "https"
                   else http.client.HTTPConnection)
            conn = self._conns[(scheme, netloc)] = cls(
                netloc, timeout=timeout, blocksize=1 << 20)
        conn.timeout = timeout
        if conn.sock is not None:
            conn.sock.settimeout(timeout)
        return conn

    def request(self, method: str, url: str, *, data=None, json=None,
                headers: Optional[Dict[str, str]] = None,
                params: Optional[Dict[str, str]] = None,
                timeout: Optional[float] = None,
                data_factory: Optional[Callable[[], object]] = None,
                stream: bool = False):
        parts = urlsplit(url)
        path = parts.path or "/"
        query = parts.query
        if params:
            query = f"{query}&{urlencode(params)}" if query else urlencode(params)
        if query:
            path = f"{path}?{query}"
        hdrs = dict(headers or {})
        if json is not None:
            data = _json.dumps(json).encode()
            hdrs.setdefault("Content-Type", "application/json")
        for fresh in (False, True):
            if data_factory is not None:
                data = data_factory()
            if data is None and method in ("POST", "PUT"):
                data = b""
            size = _body_length(data)
            if size is not None:
                hdrs["Content-Length"] = str(size)
            conn = self._conn(parts.scheme, parts.netloc, timeout)
            reused = conn.sock is not None
            try:
                conn.request(method, path, body=data, headers=hdrs)
                resp = conn.getresponse()
                if stream and resp.status == 200:
                    return StreamedResponse(resp.status, resp.headers, resp,
                                            conn)
                body = resp.read()
            except TRANSPORT_ERRORS:
                conn.close()
                if reused and not fresh:
                    continue
                raise
            if resp.will_close:
                conn.close()
            return Response(resp.status, resp.headers, body)
        raise AssertionError("unreachable")

    def get(self, url: str, **kw) -> Response:
        return self.request("GET", url, **kw)

    def post(self, url: str, **kw) -> Response:
        return self.request("POST", url, **kw)

    def close(self) -> None:
        for conn in self._conns.values():
            conn.close()
        self._conns.clear()


_TLS = threading.local()


def session() -> Session:
    """This thread's session (created on first use, reused after)."""
    sess = getattr(_TLS, "session", None)
    if sess is None:
        sess = _TLS.session = Session()
    return sess


_EXEC: Optional[ThreadPoolExecutor] = None
_EXEC_SIZE = 0
_EXEC_LOCK = threading.Lock()


def _executor(size: int) -> ThreadPoolExecutor:
    global _EXEC, _EXEC_SIZE
    with _EXEC_LOCK:
        if _EXEC is None or _EXEC_SIZE != size:
            if _EXEC is not None:
                _EXEC.shutdown(wait=False)
            _EXEC = ThreadPoolExecutor(max_workers=size,
                                       thread_name_prefix="kt-store")
            _EXEC_SIZE = size
        return _EXEC


# ---------------------------------------------------------------------------
# The resilient request
# ---------------------------------------------------------------------------

# per-netloc circuit breakers (opt-in: KT_STORE_BREAKER_THRESHOLD > 0),
# each replica of a ring tripping on its own
_BREAKERS: Dict[str, CircuitBreaker] = {}
_BREAKERS_LOCK = threading.Lock()


def _breaker_for(url: str) -> Optional[CircuitBreaker]:
    try:
        threshold = int(os.environ.get("KT_STORE_BREAKER_THRESHOLD", "0"))
    except ValueError:
        threshold = 0
    if threshold <= 0:
        return None
    netloc = urlsplit(url).netloc
    with _BREAKERS_LOCK:
        br = _BREAKERS.get(netloc)
        if br is None or br.failure_threshold != threshold:
            br = _BREAKERS[netloc] = CircuitBreaker(
                failure_threshold=threshold,
                cooldown_s=float(os.environ.get("KT_STORE_BREAKER_COOLDOWN_S",
                                                "5")))
        return br


def request(method: str, url: str, *, timeout: Optional[float] = None,
            data_factory: Optional[Callable[[], object]] = None,
            **kwargs):
    """``session().request`` with the store retry policy applied.

    Every store op is content-addressed (puts are keyed by hash, gets and
    deletes are idempotent), so transport errors and 502/503/504 retry
    with exponential backoff and full jitter, honouring ``Retry-After``.
    Other statuses return at once. A 507 (store disk full) is not retried:
    it raises :class:`StoreFullError`, rebuilt from the server's body when
    it carries one. ``data_factory`` makes the body anew for every
    attempt (an open file is consumed by the attempt that failed);
    ``stream=True`` returns a 200 unread (:class:`StreamedResponse`)."""
    breaker = _breaker_for(url)

    def attempt(_i):
        t = timeout if timeout is not None else store_timeout()
        return session().request(method, url, timeout=t,
                                 data_factory=data_factory, **kwargs)

    def resp_retry(resp):
        if resp.status_code not in RETRYABLE_STATUSES:
            return None
        ra = retry_after_seconds(resp)
        return ra if ra is not None else True

    if telemetry.enabled():
        sp = telemetry.span("store.request", method=method,
                            path=url.split("/", 3)[-1][:120])
    else:
        sp = telemetry.NOOP_SPAN
    with sp:
        if sp:
            hdrs = dict(kwargs.get("headers") or {})
            hdrs[telemetry.TRACE_HEADER] = f"{sp.trace_id}-{sp.span_id}"
            kwargs["headers"] = hdrs
        resp = store_policy().run(
            attempt, retryable_exc=lambda e: isinstance(e, TRANSPORT_ERRORS),
            response_retry_delay=resp_retry, breaker=breaker)
        if sp:
            sp.set_attr("status", resp.status_code)
            sp.set_attr("bytes", (resp.headers.get("Content-Length")
                                  if isinstance(resp, StreamedResponse)
                                  else len(resp.content)))
    if resp.status_code == 507:
        raise _store_full_error(resp, url)
    return resp


def _store_full_error(resp: Response, url: str) -> StoreFullError:
    exc = None
    try:
        data = resp.json()
        if isinstance(data, dict) and data.get("error_type"):
            exc = rehydrate_exception(data)
    except ValueError:
        pass
    if not isinstance(exc, StoreFullError):
        exc = StoreFullError(f"store at {url} is out of disk space (507)")
    exc.status_code = 507
    return exc


def map_concurrent(fn: Callable[[T], R], items: Iterable[T]) -> List[R]:
    """``[fn(x) for x in items]``, fanned out over the shared executor, in
    input order; the first worker exception propagates. With
    ``KT_STORE_CONCURRENCY=1`` or one item, a plain serial loop."""
    todo = list(items)
    width = store_concurrency()
    if width <= 1 or len(todo) <= 1:
        return [fn(x) for x in todo]
    futures = [_executor(width).submit(fn, x) for x in todo]
    return [f.result() for f in futures]
