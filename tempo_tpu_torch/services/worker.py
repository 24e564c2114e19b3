"""Querier worker: attaches a standalone querier process to remote
query-frontends and pulls jobs (port of tempo_tpu/services/worker.py).

Reference: modules/querier/worker -- each querier dials every frontend
and runs processor loops that recv a job, execute it locally, and send
the result back (frontend_processor.go:57-80). Here the stream is HTTP
long-poll against /internal/jobs/poll + /internal/jobs/result; the
frontend's queue and lease bookkeeping live in services/frontend.py.
The jobs run on the querier's TempoDB device. The JAX package's kernel
telemetry and self-trace recorder around each job are not ported
(ROADMAP §A item 9); `jobs_skipped` counts the jobs whose caller's
deadline had passed.
"""

from __future__ import annotations

import json
import random
import threading
import urllib.error
import urllib.request

from ..db.search import request_from_dict, response_to_dict
from ..wire import otlp_json
from .frontend import _retryable
from .querier import Querier


def _metas_for(querier: Querier, tenant: str, block_ids: list):
    """Resolve block ids against the local blocklist, refreshing once on
    poll lag (the same retry the single-job kinds do)."""
    metas = querier.db.blocklist.metas_by_id(tenant, block_ids)
    if len(metas) != len(block_ids):
        querier.db.poll_now()
        metas = querier.db.blocklist.metas_by_id(tenant, block_ids)
        if len(metas) != len(block_ids):
            raise OSError("blocklist lags the frontend: unknown block ids")
    return metas


def _trace_wire(tr) -> dict:
    return {"trace": otlp_json.dumps(tr) if tr is not None else None}


def execute_job(querier: Querier, tenant: str, kind: str, payload: dict) -> dict:
    """Run one wire job against the local querier; returns the wire
    result dict (the inverse of frontend.decode_job_result)."""
    if kind == "multi":
        # frontend-merged same-key jobs: execute as ONE coalesced call so
        # the fused kernel batch forms here too (db/batchexec); kinds
        # without a multi API fall back to a per-job loop. Per-job
        # failures ship as __job_error__ markers so one poisoned query
        # never fails (or retries) its window-mates at the frontend.
        sub = payload["kind"]
        tenants = payload["tenants"]
        jobs = payload["jobs"]

        def wire(r, encode):
            if isinstance(r, Exception):
                return {"__job_error__": f"{type(r).__name__}: {r}",
                        "__retryable__": _retryable(r)}
            return encode(r)

        try:
            if sub == "search_blocks":
                items = [(t, _metas_for(querier, t, p["block_ids"]),
                          request_from_dict(p["req"]))
                         for t, p in zip(tenants, jobs)]
                return {"results": [
                    wire(r, response_to_dict)
                    for r in querier.search_blocks_multi(items)]}
            if sub == "search_block_shard":
                items = [(t, _metas_for(querier, t, [p["block_id"]])[0],
                          request_from_dict(p["req"]), p["groups"])
                         for t, p in zip(tenants, jobs)]
                return {"results": [
                    wire(r, response_to_dict)
                    for r in querier.search_block_shard_multi(items)]}
            if sub == "find_blocks":
                items = [(t, bytes.fromhex(p["trace_id"]),
                          _metas_for(querier, t, p["block_ids"]))
                         for t, p in zip(tenants, jobs)]
                return {"results": [
                    wire(tr, _trace_wire)
                    for tr in querier.find_in_blocks_multi(items)]}
        except Exception:  # noqa: BLE001 - the coalesced call failed: degrade to per job
            pass
        out = []
        for t, p in zip(tenants, jobs):
            try:
                out.append(execute_job(querier, t, sub, p))
            except Exception as e:  # noqa: BLE001 - shipped as this job's error marker
                out.append(wire(e, None))
        return {"results": out}
    if kind == "search_recent":
        req = request_from_dict(payload["req"])
        return response_to_dict(querier.search_recent(tenant, req))
    if kind == "search_blocks":
        req = request_from_dict(payload["req"])
        metas = _metas_for(querier, tenant, payload["block_ids"])
        return response_to_dict(querier.search_blocks(tenant, metas, req))
    if kind == "search_block_shard":
        req = request_from_dict(payload["req"])
        metas = _metas_for(querier, tenant, [payload["block_id"]])
        return response_to_dict(
            querier.search_block_shard(tenant, metas[0], req, payload["groups"])
        )
    if kind == "metrics_query_range":
        from ..db.metrics_exec import (
            request_from_dict as metrics_request_from_dict,
            response_to_dict as metrics_response_to_dict,
        )

        mreq = metrics_request_from_dict(payload["req"])
        return metrics_response_to_dict(querier.metrics_query_range(tenant, mreq))
    if kind == "find_recent":
        return _trace_wire(querier.find_trace_by_id(
            tenant, bytes.fromhex(payload["trace_id"]), query_backend=False))
    if kind == "find_blocks":
        metas = querier.db.blocklist.metas_by_id(tenant, payload["block_ids"])
        return _trace_wire(
            querier.find_in_blocks(tenant, bytes.fromhex(payload["trace_id"]), metas))
    raise ValueError(f"unknown job kind {kind!r}")


class QuerierWorker:
    """Long-poll worker loops against one or more frontend addresses."""

    def __init__(self, querier: Querier, frontend_addrs: list[str],
                 token: str = "", concurrency: int = 4, poll_wait_s: float = 5.0,
                 worker_id: str = ""):
        self.querier = querier
        self.addrs = [a.rstrip("/") for a in frontend_addrs]
        self.token = token
        self.poll_wait_s = poll_wait_s
        self.worker_id = worker_id
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._loop, args=(addr,), daemon=True,
                             name=f"querier-worker-{addr}-{i}")
            for addr in self.addrs
            for i in range(concurrency)
        ]
        self._lock = threading.Lock()
        self.jobs_executed = 0
        self.jobs_failed = 0
        self.jobs_skipped = 0

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()

    # frontend-down backoff: exponential with full jitter, capped -- a
    # restarting frontend must not be thundering-herded by a fleet of
    # workers all polling again on the same fixed 1 s tick
    BACKOFF_BASE_S = 0.5
    BACKOFF_CAP_S = 5.0

    def _post(self, addr: str, path: str, payload: dict, timeout: float) -> dict | None:
        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["X-Tempo-Internal-Token"] = self.token
        req = urllib.request.Request(
            addr + path, data=json.dumps(payload).encode(), headers=headers
        )
        with urllib.request.urlopen(req, timeout=timeout) as r:
            body = r.read()
            return json.loads(body) if body else None

    def _bump(self, name: str) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + 1)

    def _loop(self, addr: str) -> None:
        backoff = self.BACKOFF_BASE_S
        while not self._stop.is_set():
            try:
                job = self._post(addr, "/internal/jobs/poll",
                                 {"wait_s": self.poll_wait_s,
                                  "worker_id": self.worker_id},
                                 timeout=self.poll_wait_s + 10.0)
            except (urllib.error.URLError, ConnectionError, OSError):
                # full jitter: sleep U(0, backoff), then double the cap
                self._stop.wait(random.random() * backoff)
                backoff = min(backoff * 2, self.BACKOFF_CAP_S)
                continue
            backoff = self.BACKOFF_BASE_S  # frontend answered: reset
            if not job or not job.get("id"):
                continue
            # deadline propagation: the frontend stamps the caller's
            # REMAINING time budget (relative seconds, so worker and
            # frontend clocks never need to agree) on the wire job --
            # a non-positive budget means the caller already gave up
            # and dispatch cancelled the job; scanning would burn
            # device time nobody can use
            dl = job.get("deadline_in_s")
            if dl is not None and float(dl) <= 0.0:
                self._bump("jobs_skipped")
                try:
                    # skipped=True: the job never exercised the backend
                    # -- it must not feed the frontend's breaker stats
                    self._post(addr, "/internal/jobs/result",
                               {"id": job["id"], "ok": False,
                                "error": "deadline exceeded before "
                                         "execution", "retryable": False,
                                "skipped": True},
                               timeout=10.0)
                except (urllib.error.URLError, ConnectionError, OSError):
                    pass
                continue
            out = {"id": job["id"]}
            try:
                result = execute_job(
                    self.querier, job.get("tenant", ""), job["kind"], job["payload"]
                )
                out.update(ok=True, result=result)
                self._bump("jobs_executed")
            except Exception as e:  # noqa: BLE001 - report, let the frontend retry
                out.update(ok=False, error=f"{type(e).__name__}: {e}",
                           retryable=_retryable(e))
                self._bump("jobs_failed")
            try:
                self._post(addr, "/internal/jobs/result", out, timeout=10.0)
            except (urllib.error.URLError, ConnectionError, OSError):
                continue  # lease expiry re-dispatches the job
