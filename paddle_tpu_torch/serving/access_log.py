"""Shared JSONL access-log writer (port of
``paddle_tpu/serving/access_log.py``; the gateway's, and the router's
once the control plane is ported).

One locked single-write appends each record as a whole line —
concurrent handler threads at worst interleave whole lines, the same
contract as ``registry.write_snapshot``. Disabled when pathless; a
full disk must not fail requests.

Size bounding: with ``max_mb > 0`` the log rotates the moment an
append pushes it past the cap — the current file renames to
``<path>.1`` (replacing the previous rollover: keep-1) and appends
continue into a fresh file, so a long-lived front door holds at most
~2x the cap on disk. Rotation happens under the same lock as the
write, so no line is ever torn across the boundary; rotations are
counted (``access_log_rotations``).

Several PROCESSES may share one path (a replica pool appending to one
gateway log): appends stay line-atomic via O_APPEND, and rotation is
guarded against the cross-process race — an fcntl flock (where
available) serializes writers, and the rotor re-checks that its fd
still IS the live file (inode match) before renaming, so a peer that
rotated first can't have its freshly-preserved ``.1`` history
clobbered by the near-empty successor.
"""

from __future__ import annotations

import json
import os
import threading

from ..fluid import profiler as _profiler

__all__ = ["AccessLog"]

try:
    from fcntl import LOCK_EX as _LOCK_EX
    from fcntl import flock as _flock
except ImportError:  # non-POSIX: in-process lock + inode check only
    _flock = None


class AccessLog(object):
    def __init__(self, path, max_mb=0.0):
        self.path = str(path) if path else None
        try:
            self.max_bytes = int(float(max_mb or 0.0) * 1024 * 1024)
        except (TypeError, ValueError):
            self.max_bytes = 0
        self._lock = threading.Lock()

    def write(self, record):
        if not self.path:
            return
        line = json.dumps(record, sort_keys=True) + "\n"
        try:
            with self._lock:
                with open(self.path, "a") as f:
                    if self.max_bytes > 0 and _flock is not None:
                        _flock(f, _LOCK_EX)  # released when f closes
                    f.write(line)
                    size = f.tell()
                    if self.max_bytes > 0 and size >= self.max_bytes:
                        # a peer process may have rotated between our
                        # open and here (its full file is now .1, the
                        # path is a fresh near-empty file): only rotate
                        # while this fd still IS the live file
                        try:
                            live = os.stat(self.path).st_ino == os.fstat(
                                f.fileno()).st_ino
                        except OSError:
                            live = False
                        if live:
                            # keep-1 rollover: the previous .1 (one full
                            # cap of history) is the price of a bounded
                            # disk footprint
                            os.replace(self.path, self.path + ".1")
                            _profiler.bump_counter("access_log_rotations")
        except OSError:
            pass
