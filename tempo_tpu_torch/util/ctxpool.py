"""Context-propagating thread pool (port of tempo_tpu/util/ctxpool.py).

ThreadPoolExecutor workers run with the contextvars of whatever thread
happened to create them, so ambient per-query state set by the caller
would vanish on every pooled leg. This subclass captures the SUBMITTING
thread's context per task and runs the callable under a copy; the
querier's pool is one. Executor.map routes through submit, so both
entry points propagate.
"""

from __future__ import annotations

import contextvars
from concurrent.futures import ThreadPoolExecutor


class ContextThreadPool(ThreadPoolExecutor):
    def submit(self, fn, /, *args, **kwargs):
        ctx = contextvars.copy_context()
        return super().submit(ctx.run, fn, *args, **kwargs)
