"""Transformer-stack logging — port of ``apex_tpu/transformer/log_util.py``
(apex ``transformer/log_util.py``: ``get_transformer_logger`` returns a
per-module child of the package's logger, ``set_logging_level`` sets the
package logger's level)."""

from __future__ import annotations

import logging

_ROOT_NAME = "apex_tpu_torch"


def get_transformer_logger(name: str) -> logging.Logger:
    """Child logger under the package root (apex: ``apex.transformer.X``)."""
    name_wo_ext = name.split(".")[0]
    return logging.getLogger(f"{_ROOT_NAME}.transformer.{name_wo_ext}")


def set_logging_level(verbosity) -> None:
    """Set the package root logger's level (apex ``set_logging_level``)."""
    logging.getLogger(_ROOT_NAME).setLevel(verbosity)
