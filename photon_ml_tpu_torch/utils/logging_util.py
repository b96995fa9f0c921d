"""Logger + stage timers (port of ``photon_ml_tpu/utils/logging_util.py``).

Reference: photon-ml .../util/PhotonLogger.scala:36-105 (SLF4J-style logger
writing to a local file, copied to the job dir on close) and
util/Timer.scala:32-80 (explicit start/stop nanosecond timers wrapping every
driver stage, cli/game/training/Driver.scala:642-712).
"""

from __future__ import annotations

import logging
import os
import time
from contextlib import contextmanager
from typing import Dict, Optional


class PhotonLogger:
    """File+console logger bound to a job output directory."""

    def __init__(self, output_dir: Optional[str] = None, name: str = "photon-ml-tpu",
                 level: int = logging.DEBUG):
        self._logger = logging.getLogger(f"{name}-{id(self)}")
        self._logger.setLevel(level)
        self._logger.propagate = False
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        self._logger.addHandler(sh)
        self._file_handler = None
        if output_dir is not None:
            os.makedirs(output_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(output_dir, "photon.log"))
            fh.setFormatter(fmt)
            self._logger.addHandler(fh)
            self._file_handler = fh

    def debug(self, msg, *args):
        self._logger.debug(msg, *args)

    def info(self, msg, *args):
        self._logger.info(msg, *args)

    def warning(self, msg, *args):
        self._logger.warning(msg, *args)

    def error(self, msg, *args):
        self._logger.error(msg, *args)

    def close(self):
        if self._file_handler is not None:
            self._logger.removeHandler(self._file_handler)
            self._file_handler.close()
            self._file_handler = None


class Timer:
    """Named stage timers; durations in seconds (Timer.scala analog)."""

    def __init__(self):
        self._starts: Dict[str, float] = {}
        self.durations: Dict[str, float] = {}

    def start(self, name: str) -> None:
        if name in self._starts:
            raise RuntimeError(f"timer {name!r} already running")
        self._starts[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        if name not in self._starts:
            raise RuntimeError(f"timer {name!r} not running")
        d = time.perf_counter() - self._starts.pop(name)
        self.durations[name] = self.durations.get(name, 0.0) + d
        return d

    @contextmanager
    def time(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    def summary(self) -> str:
        return "\n".join(
            f"  {k}: {v:.3f}s" for k, v in sorted(self.durations.items())
        )
