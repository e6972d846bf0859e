"""Span tracing for the decode pipeline.

Behavioral parity: the reference instruments every pipeline stage with
`tracing` spans (e.g. lf_global.rs:63 "Decode Patches", vardct/mod.rs:55
"Render VarDCT", render/lib.rs:944 "Transform to requested color
encoding") and the CLI installs a fmt subscriber with -v/-vv verbosity
(cli/main.rs:31-45). Here spans emit DEBUG logs with wall-time on exit
and, when JXL_TPU_TRACE_ANNOTATE=1, nest inside torch.profiler
record_function ranges so host stages line up with CUDA kernels in a
torch.profiler trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

__all__ = ["logger", "set_verbosity", "span", "traced"]

logger = logging.getLogger("jxl_oxide_tpu_torch")
_configured = False


def set_verbosity(level: int) -> None:
    """The CLI's -v: 0 = warnings, 1 or more = the DEBUG span records on
    stderr (jxl_oxide_tpu/utils/trace.py set_verbosity)."""
    global _configured
    if not _configured:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(handler)
        _configured = True
    logger.setLevel(logging.WARNING if level <= 0 else logging.DEBUG)


_FORCE_ANNOTATE = os.environ.get("JXL_TPU_TRACE_ANNOTATE", "") == "1"


def traced(name: str):
    """Decorator form of span() for whole pipeline stages."""

    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


@contextlib.contextmanager
def span(name: str, **fields):
    """Trace one pipeline stage. Cheap when logging is disabled."""
    enabled = logger.isEnabledFor(logging.DEBUG)
    if not (enabled or _FORCE_ANNOTATE):
        yield
        return
    ctx = contextlib.nullcontext()
    if _FORCE_ANNOTATE:
        import torch.profiler

        ctx = torch.profiler.record_function(name)
    t0 = time.perf_counter()
    with ctx:
        try:
            yield
        finally:
            if enabled:
                dt = (time.perf_counter() - t0) * 1e3
                extra = "".join(f" {k}={v}" for k, v in fields.items())
                logger.debug("%s: %.2f ms%s", name, dt, extra)
