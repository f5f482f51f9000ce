"""Embedding serving launcher — the read path of the train→publish→serve
loop.

Point it at an artifact directory that ``repro_torch.launch.train_sgns
--publish`` (or either package's ``publish_incremental``) wrote:

  # one-shot query from the CLI (raw word ids, comma-separated)
  PYTHONPATH=src python -m repro_torch.launch.serve --artifact artifacts/ \\
      --query 11,42,7

  # a worker's own space: present rows served, absent rows
  # reconstructed on the fly (Y @ W_i.T)
  PYTHONPATH=src python -m repro_torch.launch.serve --artifact artifacts/ \\
      --query 11,42,7 --submodel 2

  # long-running JSON-lines TCP server (requests: {"ids": [...]},
  # {"op": "stats"}, {"op": "refresh"} — see repro_torch.serve.tcp)
  PYTHONPATH=src python -m repro_torch.launch.serve --artifact artifacts/ \\
      --port 8765

The counterpart of ``repro.launch.serve``, with ``--device`` added: the
table is served from the GPU unless ``--device cpu`` is given. The server
polls the artifact manifest every ``--refresh-s`` seconds and hot-swaps to
newer versions as the incremental merge publishes them.
"""

from __future__ import annotations

import argparse
import asyncio

import numpy as np

from repro_torch.serve import ArtifactStore, EmbeddingServer, ServeConfig, start_tcp_server


def _config(args) -> ServeConfig:
    return ServeConfig(coalesce_ms=args.coalesce_ms, max_batch=args.max_batch,
                       max_concurrency=args.concurrency,
                       cache_rows=args.cache_rows)


async def query_once(server: EmbeddingServer, raw_ids: list[int],
                     submodel: int | None) -> None:
    res = await server.embed_ids(np.asarray(raw_ids), submodel=submodel)
    space = "merged" if submodel is None else f"submodel {submodel}"
    print(f"artifact v{res['version']}  space={space}  dim="
          f"{res['vectors'].shape[1]}")
    for rid, vec, ok in zip(raw_ids, res["vectors"], res["found"]):
        head = np.array2string(vec[:4], precision=3, suppress_small=True)
        status = "ok " if ok else "OOV"
        print(f"  id {rid:>8d} [{status}] ‖v‖={np.linalg.norm(vec):6.3f}  "
              f"{head}…")
    s = server.stats()
    print(f"stats: p50 {s['p50_ms']:.2f} ms  p99 {s['p99_ms']:.2f} ms  "
          f"mean batch {s['mean_batch']:.1f}  "
          f"cache hit rate {s['cache_hit_rate']:.2f}")


async def run_tcp(server: EmbeddingServer, host: str, port: int,
                  refresh_s: float) -> None:
    srv = await start_tcp_server(server, host, port)
    actual = srv.sockets[0].getsockname()[1]
    print(f"serving artifact v{server.store.version} on {host}:{actual} "
          f"(JSON lines; Ctrl-C to stop)")

    async def poll():
        while True:
            await asyncio.sleep(refresh_s)
            if server.refresh():
                print(f"hot-swapped to artifact v{server.store.version}")

    poller = asyncio.create_task(poll())
    try:
        async with srv:
            await srv.serve_forever()
    finally:
        poller.cancel()


def build_parser() -> argparse.ArgumentParser:
    """The reference's parser, plus ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--artifact", required=True,
                    help="artifact directory (publish_table output)")
    ap.add_argument("--query", default=None,
                    help="comma-separated raw word ids: answer once and exit")
    ap.add_argument("--submodel", type=int, default=None,
                    help="serve in this worker's sub-model space "
                         "(absent rows reconstructed on the fly)")
    ap.add_argument("--port", type=int, default=None,
                    help="run the JSON-lines TCP server on this port "
                         "(0 = ephemeral)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--version", type=int, default=None,
                    help="pin a table version (default: track latest)")
    ap.add_argument("--coalesce-ms", type=float, default=2.0)
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--concurrency", type=int, default=4)
    ap.add_argument("--cache-rows", type=int, default=4096)
    ap.add_argument("--refresh-s", type=float, default=2.0,
                    help="manifest poll interval for hot reloads")
    ap.add_argument("--device", default=None,
                    help="torch device of the served table (default: the "
                         "GPU; raises without one unless 'cpu' is given)")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.query is None and args.port is None:
        ap.error("one of --query or --port is required")
    store = ArtifactStore(args.artifact, version=args.version, device=args.device)
    server = EmbeddingServer(store, _config(args))

    if args.query is not None:
        ids = [int(x) for x in args.query.split(",") if x.strip()]
        asyncio.run(query_once(server, ids, args.submodel))
        return
    try:
        asyncio.run(run_tcp(server, args.host, args.port, args.refresh_s))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
