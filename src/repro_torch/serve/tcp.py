"""JSON-lines TCP front end for :class:`~repro_torch.serve.server.EmbeddingServer`
(a copy of ``repro.serve.tcp``).

One request per line, one response line back — a protocol simple enough
that ``nc`` is a valid client. Requests::

    {"ids": [3, 17, 99]}                     merged-space lookup (raw ids)
    {"ids": [3], "submodel": 2}              worker 2's space (reconstructs)
    {"rows": [0, 1, 2]}                      table-row ids, skip vocab map
    {"op": "stats"}                          serving telemetry
    {"op": "refresh"}                        hot-swap to the newest version

Responses mirror :meth:`EmbeddingServer.embed_ids` with lists instead
of arrays, plus ``{"error": ...}`` on malformed input (the connection
stays open). Concurrent requests across connections coalesce into the
same batches — the whole point of fronting one server object.
"""

from __future__ import annotations

import asyncio
import json

import numpy as np

from repro_torch.serve.server import EmbeddingServer


async def _handle_line(server: EmbeddingServer, line: bytes) -> dict:
    try:
        req = json.loads(line)
        if not isinstance(req, dict):
            raise ValueError("request must be a JSON object")
        op = req.get("op", "embed")
        if op == "stats":
            return {"stats": server.stats()}
        if op == "refresh":
            return {"refreshed": server.refresh(),
                    "version": server.store.version}
        if op != "embed":
            raise ValueError(f"unknown op {op!r}")
        submodel = req.get("submodel")
        if "rows" in req:
            res = await server.embed_rows(np.asarray(req["rows"]),
                                          submodel=submodel)
        else:
            res = await server.embed_ids(np.asarray(req["ids"]),
                                         submodel=submodel)
        return {"vectors": res["vectors"].tolist(),
                "found": res["found"].tolist(),
                "version": res["version"]}
    except Exception as e:               # malformed request ≠ dead server
        return {"error": f"{type(e).__name__}: {e}"}


async def _serve_connection(server: EmbeddingServer,
                            reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
    try:
        while line := await reader.readline():
            if not line.strip():
                continue
            resp = await _handle_line(server, line)
            writer.write(json.dumps(resp).encode() + b"\n")
            await writer.drain()
    finally:
        writer.close()


async def start_tcp_server(server: EmbeddingServer, host: str = "127.0.0.1",
                           port: int = 0) -> asyncio.base_events.Server:
    """Start serving; ``port=0`` picks a free port (read it back from
    ``srv.sockets[0].getsockname()[1]``). Caller owns the lifetime
    (``srv.close(); await srv.wait_closed()``)."""
    return await asyncio.start_server(
        lambda r, w: _serve_connection(server, r, w), host, port)


async def request_once(host: str, port: int, payload: dict) -> dict:
    """One request/response round trip — the reference client."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(json.dumps(payload).encode() + b"\n")
        await writer.drain()
        return json.loads(await reader.readline())
    finally:
        writer.close()
