"""The training log, the live-metric logger, and the log's flag re-parser.

A copy of ``multimodalgame_tpu/utils/logging.py``:

* ``FileLogger`` (reference misc.py:153-184): ``[level] message`` on
  stderr, and ``%y-%m-%d %H:%M:%S [level] message`` appended to the log
  file, which is reopened for every write;
* ``VisdomLogger`` (misc.py:95-151): keeps every point in ``history``
  and, with ``enabled``, ships them to a Visdom server once ``minimum``
  points of a key have gathered (``visdom`` is imported only then);
* ``read_log_load`` (misc.py:193-217): the "Flag Values" JSON block of a
  training log.
"""

from __future__ import annotations

import datetime
import json
import sys
from typing import Dict, List, Optional, Tuple


class FileLogger:
    """Leveled logger writing to stderr and (re-opened per write) to a file."""

    DEBUG = 0
    INFO = 1
    WARNING = 2
    ERROR = 3

    def __init__(self, log_path: Optional[str] = None,
                 min_print_level: int = 0, min_file_level: int = 0):
        self.log_path = log_path
        self.min_print_level = min_print_level
        self.min_file_level = min_file_level

    def Log(self, message: str, level: int = INFO) -> None:
        if level >= self.min_print_level:
            sys.stderr.write("[%i] %s\n" % (level, message))
        if self.log_path and level >= self.min_file_level:
            with open(self.log_path, "a") as f:
                datetime_string = datetime.datetime.now().strftime(
                    "%y-%m-%d %H:%M:%S")
                f.write("%s [%i] %s\n" % (datetime_string, level, message))


class VisdomLogger:
    """Buffered live-metric logger with an in-memory ``history``."""

    def __init__(self, env: str = "main", experiment_name: str = "",
                 minimum: int = 2, enabled: bool = False, viz=None):
        self.enabled = enabled
        self.experiment_name = experiment_name
        self.env = env
        self.minimum = minimum
        self.q: Dict[str, List[Tuple[int, float]]] = {}
        self.history: Dict[str, List[Tuple[int, float]]] = {}
        self.viz = viz
        if enabled and viz is None:
            try:
                from visdom import Visdom  # type: ignore
                self.viz = Visdom()
            except Exception:
                # No server or no package: the history still records.
                self.viz = None

    def get_metrics(self, key, val, step):
        metric = self.q.setdefault(key, [])
        metric.append((step, val))
        if len(metric) >= self.minimum:
            del self.q[key]
            return metric
        return None

    def _ship(self, key, steps, vals) -> None:
        """Send one trace update with ``line(..., update="append")``; an
        old server without that keyword takes the reference's
        ``updateTrace`` (misc.py:135-140)."""
        opts = {"legend": [self.experiment_name], "title": key}
        try:
            win = self.viz.line(X=steps, Y=vals, win=key, env=self.env,
                                name=self.experiment_name,
                                update="append", opts=opts)
        except TypeError:
            win = self.viz.updateTrace(X=steps, Y=vals,
                                       name=self.experiment_name, win=key,
                                       env=self.env, append=True)
        if win == "win does not exist":
            self.viz.line(X=steps, Y=vals, win=key, env=self.env,
                          opts=opts)

    def log(self, key: str, val: float, step: int) -> None:
        self.history.setdefault(key, []).append((step, float(val)))
        if not self.enabled:
            return
        metrics = self.get_metrics(key, val, step)
        if metrics is None or self.viz is None:
            return
        import numpy as np
        steps, vals = zip(*metrics)
        self._ship(key, np.array(steps, dtype=np.int32),
                   np.array(vals, dtype=np.float32))


def read_log_load(filename: str, last: bool = True) -> Optional[dict]:
    """Re-parse the "Flag Values" JSON block from a log file
    (reference misc.py:193-217): the last block, or the first with
    ``last=False``."""
    ret = None
    cur = None
    reading = False
    begin = "Flag Values"
    end = "}"

    with open(filename) as f:
        for line in f:
            if begin in line and not reading:
                cur = ""
                reading = True
                continue
            if reading:
                cur += line.strip()
                if end in line:
                    ret = json.loads(cur)
                    reading = False
                    if not last:
                        return ret
    return ret
