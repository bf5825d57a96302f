"""Structured operational logging — a tiny stdlib-logging shim, the copy of
``repro/obs/log.py``.

Serving decisions that matter to operators (a hot swap, a REFUSED swap)
are logged as one flat ``event key=value ...`` line through a normal
``logging.Logger`` (namespace ``repro_torch.*``), so any logging config —
including none — picks them up, and tests assert on them with ``caplog``:

    log = get_logger("serve.mesh")
    log_event(log, "swap_refused", served_version=3, offered_version=1)
    # repro_torch.serve.mesh: swap_refused served_version=3 offered_version=1

Values are quoted only when they contain spaces, keeping lines grep-able;
the structured fields also travel on the ``LogRecord`` as
``record.event`` / ``record.fields``.
"""

from __future__ import annotations

import logging


def get_logger(name: str) -> logging.Logger:
    """A stdlib logger under the ``repro_torch.`` namespace."""
    return logging.getLogger(f"repro_torch.{name}")


def _fmt(v) -> str:
    s = str(v)
    return f'"{s}"' if " " in s else s


def log_event(logger: logging.Logger, event: str, *,
              level: int = logging.INFO, **fields) -> str:
    """Log one structured line; returns the rendered message."""
    msg = " ".join([event] + [f"{k}={_fmt(v)}" for k, v in fields.items()])
    logger.log(level, msg, extra={"event": event, "fields": fields})
    return msg
