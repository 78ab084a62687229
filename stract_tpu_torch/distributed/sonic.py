"""sonic — typed RPC over TCP (role of reference distributed/sonic/mod.rs:
length-prefixed bincode req/resp, 1TB max body, 90s request timeout, 60s
connection TTL; the sonic_service! macro's generated dispatch is replaced by
method-name dispatch on a service object).

Wire format: 8-byte big-endian length + msgpack body (numpy arrays carried as
ext type 1: (dtype, shape, raw bytes) — postings/embeddings cross shards
without copies through JSON).

Server: asyncio (runs in a dedicated thread via serve_in_thread).
Client: blocking sockets with a per-address connection pool — the coordinator
fans out with utils.executor thread pools (reference uses tokio; the Python
build keeps the searcher synchronous and IO-threads the fan-out).
"""

from __future__ import annotations

import asyncio
import io
import socket
import struct
import threading
import time

import msgpack
import numpy as np

MAX_BODY_SIZE = 1 << 40  # 1TB (sonic/mod.rs:32)
DEFAULT_TIMEOUT = 90.0   # seconds (sonic/mod.rs:158)
CONN_TTL = 60.0          # seconds (sonic/mod.rs:33)
_HEADER = struct.Struct(">Q")


class RpcError(Exception):
    pass


class ConnectionError_(RpcError):
    pass


class ApplicationError(RpcError):
    pass


# ---- serialization -----------------------------------------------------------

def _default(obj):
    if isinstance(obj, np.ndarray):
        return msgpack.ExtType(
            1, msgpack.packb((obj.dtype.str, obj.shape, obj.tobytes()), use_bin_type=True)
        )
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    raise TypeError(f"unserializable type {type(obj)}")


def _ext_hook(code, data):
    if code == 1:
        dtype, shape, raw = msgpack.unpackb(data, raw=False)
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()
    return msgpack.ExtType(code, data)


def pack(obj) -> bytes:
    return msgpack.packb(obj, use_bin_type=True, default=_default)


def unpack(data: bytes):
    return msgpack.unpackb(data, raw=False, ext_hook=_ext_hook, strict_map_key=False)


# ---- server ---------------------------------------------------------------------

class Server:
    """Serves a `service` object: each request {"method": m, "body": b} calls
    service.m(b) (sync or async) and replies {"ok": True, "body": result}."""

    def __init__(self, service, host: str = "127.0.0.1", port: int = 0):
        self.service = service
        self.host = host
        self.port = port
        self._server: asyncio.AbstractServer | None = None
        self.addr: tuple[str, int] | None = None

    async def start(self):
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.addr = self._server.sockets[0].getsockname()[:2]
        return self

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            while True:
                header = await reader.readexactly(_HEADER.size)
                (size,) = _HEADER.unpack(header)
                if size > MAX_BODY_SIZE:
                    break
                body = await reader.readexactly(size)
                req = unpack(body)
                try:
                    method = getattr(self.service, req["method"])
                    result = method(req.get("body"))
                    if asyncio.iscoroutine(result):
                        result = await result
                except Exception as e:  # noqa: BLE001 — errors cross the wire
                    result = None
                    payload = pack({"ok": False, "error": f"{type(e).__name__}: {e}"})
                    writer.write(_HEADER.pack(len(payload)) + payload)
                    await writer.drain()
                    continue
                if isinstance(result, StreamingResponse):
                    for chunk in result.chunks:
                        payload = pack({"ok": True, "stream": True, "body": chunk})
                        writer.write(_HEADER.pack(len(payload)) + payload)
                        await writer.drain()
                    payload = pack({"ok": True, "stream_end": True})
                else:
                    payload = pack({"ok": True, "body": result})
                writer.write(_HEADER.pack(len(payload)) + payload)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        finally:
            writer.close()

    async def serve_forever(self):
        if self._server is None:
            await self.start()
        async with self._server:
            await self._server.serve_forever()


class _ServerThread:
    def __init__(self, server: Server):
        self.server = server
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self._started = threading.Event()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_until_complete(self.server.start())
        self._started.set()
        self.loop.run_forever()

    def start(self):
        self.thread.start()
        if not self._started.wait(10):
            raise RpcError("server failed to start")
        return self

    @property
    def addr(self):
        return self.server.addr

    def stop(self):
        async def _shutdown():
            if self.server._server is not None:
                self.server._server.close()
                try:
                    await self.server._server.wait_closed()
                except Exception:
                    pass

        try:
            fut = asyncio.run_coroutine_threadsafe(_shutdown(), self.loop)
            fut.result(timeout=3)
        except Exception:
            pass
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=5)


def serve_in_thread(service, host: str = "127.0.0.1", port: int = 0) -> _ServerThread:
    return _ServerThread(Server(service, host, port)).start()


class StreamingResponse:
    """Server-side chunked streaming (role of distributed/streaming_response.rs):
    a service method returns StreamingResponse(iterable) and each chunk goes out
    as its own frame; the client reads until the end marker."""

    def __init__(self, chunks):
        self.chunks = chunks


def free_socket_addr() -> tuple[str, int]:
    """(role of reference lib.rs:200 free_socket_addr) — a free localhost port."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = s.getsockname()
    s.close()
    return addr


# ---- client ----------------------------------------------------------------------

class _PooledConn:
    def __init__(self, addr, timeout):
        self.sock = socket.create_connection(addr, timeout=min(timeout, 10))
        self.sock.settimeout(timeout)
        self.created = time.monotonic()

    def expired(self) -> bool:
        return time.monotonic() - self.created > CONN_TTL

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class RemoteClient:
    """Blocking client with connection pooling + retry (role of
    sonic/replication.rs:29-151 RemoteClient and connection_pool.rs)."""

    def __init__(self, addr, timeout: float = DEFAULT_TIMEOUT, retries: int = 3):
        self.addr = tuple(addr)
        self.timeout = timeout
        self.retries = retries
        self._pool: list[_PooledConn] = []
        self._lock = threading.Lock()

    def _get_conn(self) -> _PooledConn:
        with self._lock:
            while self._pool:
                c = self._pool.pop()
                if not c.expired():
                    return c
                c.close()
        return _PooledConn(self.addr, self.timeout)

    def _put_conn(self, c: _PooledConn):
        with self._lock:
            self._pool.append(c)

    def _send_once(self, method: str, body):
        try:
            conn = self._get_conn()
        except OSError as e:
            raise ConnectionError_(str(e)) from e
        # The connection goes back to the pool only after the FULL response —
        # including every stream frame — has been consumed; returning it any
        # earlier lets a concurrent request check out the same socket
        # mid-stream and interleave reads (reference drains streaming_response
        # before connection reuse for the same reason).
        try:
            payload = pack({"method": method, "body": body})
            conn.sock.sendall(_HEADER.pack(len(payload)) + payload)
            header = self._recv_exact(conn.sock, _HEADER.size)
            (size,) = _HEADER.unpack(header)
            resp = unpack(self._recv_exact(conn.sock, size))
            chunks = None
            if resp.get("stream"):
                # drain the stream frames (role of streaming_response.rs)
                chunks = [resp["body"]]
                while True:
                    header = self._recv_exact(conn.sock, _HEADER.size)
                    (size,) = _HEADER.unpack(header)
                    frame = unpack(self._recv_exact(conn.sock, size))
                    if frame.get("stream_end"):
                        break
                    chunks.append(frame.get("body"))
        except (OSError, EOFError) as e:
            conn.close()
            raise ConnectionError_(str(e)) from e
        self._put_conn(conn)
        if not resp.get("ok"):
            raise ApplicationError(resp.get("error", "unknown remote error"))
        return chunks if chunks is not None else resp.get("body")

    @staticmethod
    def _recv_exact(sock, n: int) -> bytes:
        buf = io.BytesIO()
        got = 0
        while got < n:
            chunk = sock.recv(min(n - got, 1 << 20))
            if not chunk:
                raise EOFError("connection closed")
            buf.write(chunk)
            got += len(chunk)
        return buf.getvalue()

    def send(self, method: str, body=None):
        """Retry with exponential backoff (role of retry_strategy.rs)."""
        delay = 0.05
        last = None
        for _ in range(self.retries):
            try:
                return self._send_once(method, body)
            except ConnectionError_ as e:
                last = e
                time.sleep(delay)
                delay = min(delay * 2, 2.0)
        raise last

    def close(self):
        with self._lock:
            for c in self._pool:
                c.close()
            self._pool.clear()
