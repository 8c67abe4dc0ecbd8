"""Console logging configuration.

The root level honors ``SAGEMAKER_CONTAINER_LOG_LEVEL`` (set by the platform
from the Estimator's ``container_log_level``, as a name like ``DEBUG`` or a
stdlib numeric level like ``10``); unset or unparseable values fall back to
INFO.
"""

import logging
import logging.config
import os

LOG_LEVEL_ENV = "SAGEMAKER_CONTAINER_LOG_LEVEL"


def _resolve_level():
    raw = os.environ.get(LOG_LEVEL_ENV, "").strip()
    if not raw:
        return "INFO"
    if raw.isdigit():
        return int(raw)
    level = logging.getLevelName(raw.upper())
    # getLevelName returns the string "Level <raw>" for unknown names
    return raw.upper() if isinstance(level, int) else "INFO"


def setup_main_logger(name):
    """dictConfig console logger; returns the configured logger."""
    logging.config.dictConfig(
        {
            "version": 1,
            "disable_existing_loggers": False,
            "formatters": {
                "standard": {
                    "format": "[%(asctime)s:%(levelname)s] %(message)s",
                    "datefmt": "%Y-%m-%d:%H:%M:%S",
                }
            },
            "handlers": {
                "console": {
                    "class": "logging.StreamHandler",
                    "formatter": "standard",
                    "stream": "ext://sys.stdout",
                }
            },
            "root": {"level": _resolve_level(), "handlers": ["console"]},
        }
    )
    return logging.getLogger(name)
