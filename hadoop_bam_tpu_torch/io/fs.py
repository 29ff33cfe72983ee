"""Filesystem seam: scheme-dispatched byte-range reads under every reader.

Counterpart of ``hadoop_bam_tpu/io/fs.py`` (the role of the reference's
WrapSeekable.java:42-66 and NIOFileUtil.java:31-55 bridges): every reader
asks :func:`get_fs` for a path's filesystem and reads byte ranges through
it, so a remote store is one :func:`register_filesystem` call away and no
reader changes.  Built in: plain paths and ``file://`` (local files),
``mem://`` once registered (:class:`MemFilesystem`), ``http://`` and
``https://`` (:class:`HttpFilesystem`) and ``gs://`` once registered
(:class:`GcsFilesystem`).  Writers stay local, as in the reference.

Counters go to the job's :class:`~..utils.tracing.Metrics`, which rides
each primitive as ``metrics=`` (``None`` counts nothing): ``io.read_retries``
(:func:`read_range_retry`), ``fs.http.retries`` (the HTTP adapter's own
retries) and ``faults.fired.io.read.*`` (the fault seam of local reads).
An adapter registered by a caller takes the same keyword.

A local range read fills a fresh ``bytearray`` with ``readinto``: tensors
are made from it without a copy.
"""

from __future__ import annotations

import io
import os
import re
import threading
import time
from typing import BinaryIO, Callable, Dict, List, Optional

from .. import faults
from ..utils.tracing import Metrics

_SCHEME_RE = re.compile(r"^([A-Za-z][A-Za-z0-9+.-]*)://")


def _inject_read(path: str, start: int, data, metrics: Optional[Metrics]):
    """The byte-I/O fault seam: an armed plan may raise a transient
    ``IOError`` or return short or bit-flipped bytes.  One ``is None``
    check when disarmed."""
    if faults.ACTIVE is None:
        return data
    out = faults.ACTIVE.io_read(path, start, data, metrics)
    return out if isinstance(out, bytearray) else bytearray(out)


def _retry(call: Callable[[], bytes], retries: int, backoff_s: float,
           metrics: Optional[Metrics]) -> bytes:
    for attempt in range(retries + 1):
        try:
            return call()
        except FileNotFoundError:
            raise
        except OSError:
            if attempt == retries:
                raise
            if metrics is not None:
                metrics.count("io.read_retries", 1)
            time.sleep(backoff_s * (2 ** attempt))
    raise AssertionError("unreachable")


def read_range_retry(filesystem: "Filesystem", path: str, start: int, length: int,
                     retries: int = 2, backoff_s: float = 0.01,
                     metrics: Optional[Metrics] = None) -> bytes:
    """A ranged read with bounded retries on a transient ``OSError``
    (``io.read_retries`` counts a retry that happens).  A missing file
    raises at once."""
    return _retry(lambda: filesystem.read_range(path, start, length, metrics=metrics),
                  retries, backoff_s, metrics)


def read_all_retry(filesystem: "Filesystem", path: str, retries: int = 2,
                   backoff_s: float = 0.01, metrics: Optional[Metrics] = None) -> bytes:
    """:func:`read_range_retry` for a whole file."""
    return _retry(lambda: filesystem.read_all(path, metrics=metrics), retries, backoff_s,
                  metrics)


def path_scheme(path: str) -> str:
    """The URI scheme of ``path``, or '' for a plain local path."""
    m = _SCHEME_RE.match(path)
    return m.group(1).lower() if m else ""


class Filesystem:
    """Byte-range access for one URI scheme.  Adapters implement ``size``,
    ``read_range`` and ``open_write``; the rest defaults on top of them.
    Paths arrive as full URIs: the adapter strips its own scheme."""

    def size(self, path: str, metrics: Optional[Metrics] = None) -> int:
        raise NotImplementedError

    def read_range(self, path: str, start: int, length: int,
                   metrics: Optional[Metrics] = None) -> bytes:
        """Bytes ``[start, start + length)``; short only at EOF."""
        raise NotImplementedError

    def open_write(self, path: str) -> BinaryIO:
        raise NotImplementedError

    def read_all(self, path: str, metrics: Optional[Metrics] = None) -> bytes:
        return self.read_range(path, 0, self.size(path, metrics=metrics), metrics=metrics)

    def exists(self, path: str) -> bool:
        try:
            self.size(path)
            return True
        except (OSError, KeyError):
            return False

    def open_read(self, path: str) -> BinaryIO:
        return io.BytesIO(self.read_all(path))


class LocalFilesystem(Filesystem):
    """OS files: bare paths and ``file://`` URIs."""

    @staticmethod
    def _strip(path: str) -> str:
        return path[7:] if path.startswith("file://") else path

    def size(self, path: str, metrics: Optional[Metrics] = None) -> int:
        return os.path.getsize(self._strip(path))

    def read_range(self, path: str, start: int, length: int,
                   metrics: Optional[Metrics] = None) -> bytearray:
        buf = bytearray(max(length, 0))
        with open(self._strip(path), "rb") as f:
            f.seek(start)
            n = f.readinto(buf)
        del buf[n:]
        return _inject_read(path, start, buf, metrics)

    def read_all(self, path: str, metrics: Optional[Metrics] = None) -> bytes:
        with open(self._strip(path), "rb") as f:
            return _inject_read(path, 0, f.read(), metrics)

    def open_read(self, path: str) -> BinaryIO:
        return open(self._strip(path), "rb")

    def open_write(self, path: str) -> BinaryIO:
        return open(self._strip(path), "wb")

    def exists(self, path: str) -> bool:
        return os.path.exists(self._strip(path))


class _MemWriteStream(io.BytesIO):
    def __init__(self, fs: "MemFilesystem", path: str):
        super().__init__()
        self._fs = fs
        self._path = path

    def close(self) -> None:
        if not self.closed:
            self._fs._files[self._path] = self.getvalue()
        super().close()


class MemFilesystem(Filesystem):
    """In-memory files (``mem://``): the non-local round trip and the
    template of an adapter."""

    def __init__(self) -> None:
        self._files: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def _blob(self, path: str) -> bytes:
        try:
            return self._files[path]
        except KeyError:
            raise FileNotFoundError(path) from None

    def size(self, path: str, metrics: Optional[Metrics] = None) -> int:
        return len(self._blob(path))

    def read_range(self, path: str, start: int, length: int,
                   metrics: Optional[Metrics] = None) -> bytes:
        return self._blob(path)[start : start + length]

    def open_write(self, path: str) -> BinaryIO:
        with self._lock:
            return _MemWriteStream(self, path)

    def listdir(self, prefix: str) -> List[str]:
        return sorted(p for p in self._files if p.startswith(prefix))


class HttpFilesystem(Filesystem):
    """Read-only HTTP(S): byte ranges through ``Range`` headers.

    A server that ignores ``Range`` (status 200) is sliced on the host.
    ``headers`` ride every request, ``timeout`` is per request, and a 5xx or
    a transport error retries ``retries`` times (each retry counts
    ``retry_metric``, default ``fs.http.retries``, into the call's
    ``metrics``); a 404 raises ``FileNotFoundError``, a 416 reads as empty,
    any other 4xx fails at once."""

    def __init__(self, headers: Optional[Dict[str, str]] = None, timeout: float = 60.0,
                 retries: int = 2, retry_metric: str = "fs.http.retries") -> None:
        self._headers = dict(headers or {})
        self._timeout = timeout
        self._retries = retries
        self._retry_metric = retry_metric
        self._size_cache: Dict[str, int] = {}
        self._lock = threading.Lock()

    def _url(self, path: str) -> str:
        return path

    def _request(self, url: str, method: str, headers: Dict[str, str],
                 metrics: Optional[Metrics] = None):
        """``(status, headers, body)`` of one retried request; the body is
        read inside the retry loop (a connection lost mid-body is the
        common transient failure), ``None`` for HEAD.  A 416 returns
        ``(416, None, b"")``."""
        import http.client
        import urllib.error
        import urllib.request

        last: Optional[Exception] = None
        for attempt in range(self._retries + 1):
            req = urllib.request.Request(url, method=method)
            for k, v in {**self._headers, **headers}.items():
                req.add_header(k, v)
            try:
                with urllib.request.urlopen(req, timeout=self._timeout) as resp:
                    body = None if method == "HEAD" else resp.read()
                    return resp.status, resp.headers, body
            except urllib.error.HTTPError as e:
                if e.code == 404:
                    raise FileNotFoundError(url) from e
                if e.code == 416:
                    return 416, None, b""
                last = e
                if 400 <= e.code < 500:
                    break  # a client error does not change on retry
            except (urllib.error.URLError, OSError, http.client.HTTPException) as e:
                last = e
            if attempt < self._retries and metrics is not None:
                metrics.count(self._retry_metric, 1)
        raise OSError(f"HTTP {method} {url} failed: {last}") from last

    def size(self, path: str, metrics: Optional[Metrics] = None) -> int:
        """From HEAD's ``Content-Length``, else from a ``bytes=0-0``
        probe's ``Content-Range`` total (servers that refuse HEAD)."""
        with self._lock:
            if path in self._size_cache:
                return self._size_cache[path]
        url = self._url(path)
        n: Optional[int] = None
        try:
            _, hdrs, _ = self._request(url, "HEAD", {}, metrics)
            cl = hdrs.get("Content-Length") if hdrs else None
            if cl is not None:
                n = int(cl)
        except FileNotFoundError:
            raise
        except OSError:
            pass  # HEAD refused: probe with a one-byte range
        if n is None:
            status, hdrs, body = self._request(url, "GET", {"Range": "bytes=0-0"}, metrics)
            cr = hdrs.get("Content-Range") if hdrs else None
            if status == 206:
                total = cr.rsplit("/", 1)[1] if cr and "/" in cr else "*"
                if not total.isdigit():
                    raise OSError(f"cannot determine size of {path}: 206 without a "
                                  f"numeric Content-Range total ({cr!r})")
                n = int(total)
            elif status == 200 and body is not None:
                n = len(body)  # Range ignored: the body is the object
            else:
                raise OSError(f"cannot determine size of {path}")
        with self._lock:
            self._size_cache[path] = n
        return n

    def read_range(self, path: str, start: int, length: int,
                   metrics: Optional[Metrics] = None) -> bytes:
        if length <= 0:
            return b""
        status, _, data = self._request(
            self._url(path), "GET", {"Range": f"bytes={start}-{start + length - 1}"}, metrics)
        if data is None:
            return b""
        if status == 200:
            data = data[start : start + length]  # Range ignored: slice the object
        return data[:length]

    def read_all(self, path: str, metrics: Optional[Metrics] = None) -> bytes:
        _, _, data = self._request(self._url(path), "GET", {}, metrics)  # one round trip
        return data or b""

    def open_write(self, path: str) -> BinaryIO:
        raise OSError(f"HttpFilesystem is read-only ({path}); write outputs to a "
                      "writable scheme and serve them over HTTP separately")


class GcsFilesystem(HttpFilesystem):
    """``gs://bucket/object`` over the XML API: range reads of
    ``{endpoint}/{bucket}/{object}``, a bearer ``token`` for private
    buckets; ``endpoint`` may point at a local range-serving server."""

    ENDPOINT = "https://storage.googleapis.com"

    def __init__(self, endpoint: Optional[str] = None, token: Optional[str] = None,
                 **kw) -> None:
        headers = kw.pop("headers", {}) or {}
        if token:
            headers["Authorization"] = f"Bearer {token}"
        super().__init__(headers=headers, **kw)
        self._endpoint = (endpoint or self.ENDPOINT).rstrip("/")

    def _url(self, path: str) -> str:
        from urllib.parse import quote

        if path.startswith("gs://"):
            path = path[5:]
        # Object names may hold '#', '?', '%' and spaces: quote them.
        return f"{self._endpoint}/{quote(path, safe='/')}"


_LOCAL = LocalFilesystem()
_REGISTRY: Dict[str, Filesystem] = {
    "": _LOCAL,
    "file": _LOCAL,
    "http": HttpFilesystem(),
    "https": HttpFilesystem(),
}
_REG_LOCK = threading.Lock()


def register_filesystem(scheme: str, fs: Filesystem) -> None:
    """Install an adapter for ``scheme`` (e.g. 'gs', 'mem')."""
    with _REG_LOCK:
        _REGISTRY[scheme.lower()] = fs


def get_fs(path: str) -> Filesystem:
    scheme = path_scheme(path)
    try:
        return _REGISTRY[scheme]
    except KeyError:
        raise ValueError(f"no filesystem registered for scheme {scheme!r} "
                         f"(path {path!r}); call register_filesystem()") from None
