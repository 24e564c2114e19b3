"""Stateless search-one-block-shard handler (tempo-serverless analog;
port of tempo_tpu/serverless.py).

The reference ships a Lambda/Cloud Run handler that searches one shard
of one backend block per invocation (cmd/tempo-serverless/handler.go:49,
once-initialised reader). Same contract here: a JSON event naming the
backend, tenant, block and row-group range; the process holds a cached
backend + block-reader so warm invocations skip setup. The search runs
on the device the handler is given (None: the first card, an error
without one), through db/search.search_block (K1, K2).

    python -m tempo_tpu_torch.serverless --port 8077 [--device cpu]
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from .block.meta import BlockMeta
from .block.versioned import open_block_versioned
from .db.search import request_from_dict, response_to_dict, search_block
from .db.tempodb import open_backend
from .ops.device import resolve_device

_lock = threading.Lock()
_backends: dict = {}
_blocks: OrderedDict = OrderedDict()
_MAX_CACHED_BLOCKS = 64  # LRU cap: warm workers touch many blocks over time


def _backend_key(cfg: dict) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in cfg.items()))


def _backend(cfg: dict):
    key = _backend_key(cfg)
    with _lock:
        b = _backends.get(key)
        if b is None:
            b = _backends[key] = open_backend(cfg)
        return b


def handler(event: dict, device=None) -> dict:
    """event: {backend: {...}, tenant, block_id, groups: [lo, hi) | null,
    search: <db.search.request_to_dict form>}
    -> db.search.response_to_dict form."""
    device = resolve_device(device)
    backend = _backend(event["backend"])
    tenant = event["tenant"]
    block_id = event["block_id"]
    # keyed by backend too: a warm worker may serve events naming
    # different buckets for the same (tenant, block id)
    cache_key = (_backend_key(event["backend"]), tenant, block_id)
    with _lock:
        blk = _blocks.get(cache_key)
        if blk is not None:
            _blocks.move_to_end(cache_key)
    if blk is None:
        from .backend.base import meta_name

        meta = BlockMeta.from_json(backend.read(tenant, block_id, meta_name()))
        blk = open_block_versioned(backend, meta)
        with _lock:
            _blocks[cache_key] = blk
            while len(_blocks) > _MAX_CACHED_BLOCKS:
                _blocks.popitem(last=False)

    # the search payload and the response both reuse the internal job
    # plane's wire helpers (db/search request/response dicts) so the
    # serverless hop can never drift from the frontend's format
    req = request_from_dict(event.get("search", {}))
    groups = event.get("groups")
    groups_range = list(range(groups[0], groups[1])) if groups else None
    resp = search_block(blk, req, groups_range=groups_range, device=device)
    return response_to_dict(resp)


def serve(port: int, host: str = "127.0.0.1", device=None):
    """HTTP front for the handler: POST / with the event JSON (the
    Cloud-Run flavor of the reference's serverless deploys; Lambda would
    wrap `handler` directly). Returns the bound server (threaded); the
    device is resolved here, so a missing card fails at start."""
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    device = resolve_device(device)

    class _H(BaseHTTPRequestHandler):
        def do_POST(self):
            try:
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                out = handler(json.loads(body), device=device)
                data = json.dumps(out).encode()
                self.send_response(200)
            except Exception as e:  # noqa: BLE001 - one bad event must not kill the worker
                data = json.dumps({"error": f"{type(e).__name__}: {e}"}).encode()
                self.send_response(500)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):
            pass

    return ThreadingHTTPServer((host, port), _H)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser("tempo-serverless")
    ap.add_argument("--port", type=int, default=8077)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--device", default=None,
                    help="torch device the searches run on (default: cuda:0)")
    args = ap.parse_args(argv)
    srv = serve(args.port, args.host, device=args.device)
    print(f"tempo-serverless listening on {args.host}:{args.port}", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
