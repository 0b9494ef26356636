"""Shared library logger: ``repro_torch.obs.log.get_logger(__name__)``.

The port's copy of the JAX package's ``obs/log.py``, rooted at
``repro_torch``. Library modules (the online engine, the metrics server)
emit diagnostics through one ``repro_torch``-rooted stdlib logger instead of
ad-hoc ``print`` calls, so they are **silent by default** — under pytest,
as an imported dependency — and turn on uniformly:

  * ``REPRO_LOG_LEVEL=DEBUG`` (or ``INFO``/``WARNING``/...) in the
    environment configures the root ``repro_torch`` logger at import time.
  * ``set_level("INFO")`` does the same programmatically — the admission
    daemon calls it so its operational log is visible as a CLI.

The handler writes single-line ``LEVEL repro_torch.mod: message`` records
to stderr, leaving stdout to CLI output. Applications that configure
``logging`` themselves win: the root logger only installs its own handler
when nobody else has."""
from __future__ import annotations

import logging
import os
import sys

_ROOT_NAME = "repro_torch"
_ENV_VAR = "REPRO_LOG_LEVEL"
_DEFAULT_LEVEL = logging.WARNING

_FORMAT = "%(levelname)s %(name)s: %(message)s"


def _root() -> logging.Logger:
    return logging.getLogger(_ROOT_NAME)


def _ensure_configured() -> logging.Logger:
    root = _root()
    if not getattr(root, "_repro_obs_configured", False):
        if not root.handlers and not logging.getLogger().handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(logging.Formatter(_FORMAT))
            root.addHandler(handler)
            root.propagate = False
        env = os.environ.get(_ENV_VAR)
        root.setLevel(_level_of(env) if env else _DEFAULT_LEVEL)
        root._repro_obs_configured = True  # type: ignore[attr-defined]
    return root


def _level_of(level) -> int:
    if isinstance(level, int):
        return level
    value = logging.getLevelName(str(level).upper())
    if not isinstance(value, int):
        raise ValueError(f"unknown log level {level!r}")
    return value


def set_level(level) -> None:
    """Set the ``repro_torch`` root logger level (name like ``"DEBUG"`` or
    an int). Overrides the ``REPRO_LOG_LEVEL`` environment default."""
    _ensure_configured().setLevel(_level_of(level))


def get_logger(name: str | None = None) -> logging.Logger:
    """The ``repro_torch``-rooted logger for ``name`` (usually
    ``__name__``).

    Any dotted name is parented under ``repro_torch``
    (``repro_torch.serve.admission`` stays itself; ``launch.daemon`` becomes
    ``repro_torch.launch.daemon``), so one level/handler configuration
    governs every module of the port."""
    root = _ensure_configured()
    if not name or name == _ROOT_NAME:
        return root
    if not name.startswith(_ROOT_NAME + "."):
        name = f"{_ROOT_NAME}.{name}"
    return logging.getLogger(name)
