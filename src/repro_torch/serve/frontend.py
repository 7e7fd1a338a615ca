"""HTTP front door for ``ServeService``: OpenAI-style completions over a
raw-asyncio HTTP/1.1 server (stdlib only - no framework dependency).  The
reference's ``repro/serve/frontend.py``, unchanged.

Routes:
  * ``POST /v1/completions`` - body ``{"prompt": [token ids...],
    "max_tokens": n, "stream": bool, "deadline_s": seconds}``.  With
    ``stream=true`` the response is ``text/event-stream``: one
    ``data: {"token": t, "index": i}`` event per generated token (fed from
    the scheduler's own apply path - the streamed tokens ARE the engine's
    tokens), then ``data: {"finish_reason": ...}`` and ``data: [DONE]``.
    Without streaming, one JSON body after the request finishes.
  * ``GET /healthz`` - liveness + drain state.
  * ``GET /v1/stats`` - the scheduler counters + service watermarks
    (snapshot under the engine's stats lock - the loop thread keeps
    mutating while we serialize).
  * ``GET /metrics`` - Prometheus text exposition (version 0.0.4) of the
    engine's metric registry: TTFT / per-token / queue-wait / launch
    histograms, pdq_fallbacks / pdq_clip_rate quantization health, shed
    and occupancy series (serve/telemetry.py).
  * ``GET /v1/events`` - the structured failure/eviction/preemption/
    straggler event ring as JSONL, one event object per line.

Robustness mapping (the whole point of the front door):
  * overload   -> 429 with ``Retry-After`` (typed ``OverloadedError`` from
    the bounded admission queue; never unbounded growth),
  * draining   -> 503 (typed ``EngineDraining`` after SIGTERM/SIGINT),
  * bad input  -> 400 (malformed/oversized prompt, unsupported combo),
  * client disconnect mid-stream -> the connection watcher cancels the
    request in the scheduler (``cancel(uid)``), freeing its slot within a
    round while batch peers stay bit-exact,
  * stalled reader -> the bounded per-stream buffer overflows, the service
    cancels with a ``slow_consumer`` finish, and the SSE writer also arms
    a write timeout - a dead TCP peer cannot pin a slot.

Each connection serves one request (``Connection: close``): simple,
correct, and SSE holds its connection for the stream's lifetime anyway.
"""
from __future__ import annotations

import asyncio
import json

from .core import EngineDraining
from .service import OverloadedError, ServeService

__all__ = ["HttpFrontend"]

_MAX_BODY = 8 << 20          # 8 MiB: far beyond any token-id prompt


def _resp_bytes(code: int, reason: str, ctype: str, body: bytes,
                extra: dict | None = None) -> bytes:
    head = [f"HTTP/1.1 {code} {reason}", f"Content-Type: {ctype}",
            f"Content-Length: {len(body)}", "Connection: close"]
    for k, v in (extra or {}).items():
        head.append(f"{k}: {v}")
    return ("\r\n".join(head) + "\r\n\r\n").encode() + body


def _json_bytes(code: int, reason: str, obj: dict,
                extra: dict | None = None) -> bytes:
    return _resp_bytes(code, reason, "application/json",
                       (json.dumps(obj) + "\n").encode(), extra)


class HttpFrontend:
    """Asyncio HTTP server bound to one ``ServeService``."""

    def __init__(self, service: ServeService, host: str = "127.0.0.1",
                 port: int = 0, *, write_timeout: float = 30.0):
        self.service = service
        self.host = host
        self.port = port
        self.write_timeout = float(write_timeout)
        self._server: asyncio.AbstractServer | None = None
        self._conns: set = set()

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> "HttpFrontend":
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        conns = set(self._conns)
        if conns:
            # let in-flight handlers flush their final events (a drained
            # SSE stream's typed finish + [DONE]) instead of cancelling
            # them mid-write; bounded - a dead peer cannot pin shutdown
            await asyncio.wait(conns, timeout=self.write_timeout)

    async def serve_until(self, stop: asyncio.Event) -> None:
        """Run until ``stop`` is set (the launch driver sets it from the
        SIGTERM/SIGINT handler after requesting the service drain)."""
        if self._server is None:
            await self.start()
        await stop.wait()
        await self.stop()

    # ----------------------------------------------------------- connection
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            parsed = await self._read_request(reader)
            if parsed is None:
                writer.write(_json_bytes(400, "Bad Request",
                                         {"error": "malformed request"}))
                await writer.drain()
                return
            method, path, headers, body = parsed
            if method == "GET" and path == "/healthz":
                writer.write(_json_bytes(200, "OK", {
                    "status": "draining" if self.service.draining
                    else "serving"}))
                await writer.drain()
            elif method == "GET" and path == "/v1/stats":
                writer.write(_json_bytes(200, "OK", self.service.stats()))
                await writer.drain()
            elif method == "GET" and path == "/metrics":
                writer.write(_resp_bytes(
                    200, "OK", "text/plain; version=0.0.4; charset=utf-8",
                    self.service.metrics_text().encode()))
                await writer.drain()
            elif method == "GET" and path == "/v1/events":
                lines = "".join(json.dumps(e) + "\n"
                                for e in self.service.events())
                writer.write(_resp_bytes(200, "OK", "application/jsonl",
                                         lines.encode()))
                await writer.drain()
            elif method == "POST" and path == "/v1/completions":
                await self._completions(reader, writer, body)
            else:
                writer.write(_json_bytes(404, "Not Found",
                                         {"error": f"no route {path}"}))
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError,
                asyncio.IncompleteReadError):
            pass                        # client went away mid-exchange
        finally:
            self._conns.discard(task)
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _read_request(self, reader):
        line = (await reader.readline()).decode("latin-1").strip()
        if not line:
            return None
        parts = line.split()
        if len(parts) != 3:
            return None
        method, path = parts[0].upper(), parts[1]
        headers: dict[str, str] = {}
        while True:
            h = (await reader.readline()).decode("latin-1").rstrip("\r\n")
            if not h:
                break
            if ":" in h:
                k, v = h.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", 0) or 0)
        if n < 0 or n > _MAX_BODY:
            return None
        body = await reader.readexactly(n) if n else b""
        return method, path, headers, body

    # ---------------------------------------------------------- completions
    async def _completions(self, reader, writer, body: bytes) -> None:
        try:
            obj = json.loads(body or b"{}")
            prompt = obj["prompt"]
            max_tokens = int(obj.get("max_tokens", 16))
            stream_mode = bool(obj.get("stream", False))
            deadline_s = obj.get("deadline_s")
            deadline_s = None if deadline_s is None else float(deadline_s)
        except (KeyError, TypeError, ValueError, json.JSONDecodeError) as e:
            writer.write(_json_bytes(400, "Bad Request",
                                     {"error": f"bad request body: {e}"}))
            await writer.drain()
            return
        try:
            stream = self.service.submit(prompt, max_new=max_tokens,
                                         deadline_s=deadline_s)
        except OverloadedError as e:
            writer.write(_json_bytes(
                429, "Too Many Requests", {"error": str(e)},
                extra={"Retry-After": f"{e.retry_after:g}"}))
            await writer.drain()
            return
        except EngineDraining as e:
            writer.write(_json_bytes(503, "Service Unavailable",
                                     {"error": str(e)}))
            await writer.drain()
            return
        except (ValueError, NotImplementedError) as e:
            writer.write(_json_bytes(400, "Bad Request", {"error": str(e)}))
            await writer.drain()
            return

        loop = asyncio.get_running_loop()
        ev = asyncio.Event()
        stream.add_waker(lambda: loop.call_soon_threadsafe(ev.set))
        done = False

        async def watch_disconnect():
            # the client never sends more data on this connection; EOF (or
            # a reset) before the response finishes = it hung up -> cancel
            try:
                while await reader.read(4096):
                    pass
            except Exception:
                pass
            if not done:
                self.service.cancel(stream.uid, kind="disconnect",
                                    reason="client disconnected")

        watcher = asyncio.create_task(watch_disconnect())
        try:
            if stream_mode:
                await self._stream_sse(writer, stream, ev)
            else:
                await self._respond_once(writer, stream, ev)
            done = True
        except (ConnectionResetError, BrokenPipeError, TimeoutError,
                asyncio.TimeoutError):
            self.service.cancel(stream.uid, kind="disconnect",
                                reason="client connection lost mid-response")
        finally:
            watcher.cancel()

    async def _stream_sse(self, writer, stream, ev) -> None:
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        await writer.drain()
        idx = 0
        while True:
            ev.clear()
            toks, fin = stream.drain()
            for t in toks:
                writer.write(b"data: " + json.dumps(
                    {"token": t, "index": idx}).encode() + b"\n\n")
                idx += 1
            if toks:
                # a peer that stopped reading stalls drain(): bound it so a
                # dead TCP connection cannot pin the handler (the bounded
                # TokenStream buffer is the primary guard; this is the
                # transport-level backstop)
                await asyncio.wait_for(writer.drain(), self.write_timeout)
            if fin is not None:
                reason, error = fin
                writer.write(b"data: " + json.dumps(
                    {"finish_reason": reason, "error": error,
                     "id": stream.uid}).encode() + b"\n\n")
                writer.write(b"data: [DONE]\n\n")
                await writer.drain()
                return
            await ev.wait()

    async def _respond_once(self, writer, stream, ev) -> None:
        toks: list[int] = []
        while True:
            ev.clear()
            got, fin = stream.drain()
            toks.extend(got)
            if fin is not None:
                reason, error = fin
                break
            await ev.wait()
        writer.write(_json_bytes(200, "OK", {
            "id": stream.uid, "tokens": toks, "finish_reason": reason,
            "error": error}))
        await writer.drain()
