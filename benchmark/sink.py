"""Named pipes in place of the three output files.

The native plane opens each output path with ``open(O_WRONLY | O_CREAT |
O_TRUNC)`` and writes it (``native/src/io.cc:flush_parts``); on a FIFO
that open waits for a reader.  A thread per file opens the pipe for each
pass, reads it to its end and counts the bytes, keeping the chunks it read
until the next pass, so a pass's files cost the write system calls but no
disk.  Nothing hashes them: the newest pass's bytes are compared whole
after the window.  Each thread also reports the CPU time it spent on the
pass (``time.thread_time``), the harness's own share of the host.
"""

from __future__ import annotations

import errno
import fcntl
import os
import queue
import threading
import time

SUFFIXES = (".aln.paf", ".aln.alt.paf", ".aln.all.paf")
_F_SETPIPE_SZ = 1031


class PipeSink:
    """Three FIFOs ``<directory>/out<suffix>``; ``prefix`` is what the
    program writes to.  ``collect()`` waits for one pass's three files and
    returns their byte counts; the bytes of the newest pass are kept in
    ``last``, and the drain threads' CPU seconds of that pass in
    ``cpu_s``."""

    def __init__(self, directory: str):
        self.prefix = os.path.join(directory, "out")
        self.paths = [self.prefix + s for s in SUFFIXES]
        for p in self.paths:
            os.mkfifo(p)
        self._stop = False
        self._queues = [queue.Queue() for _ in self.paths]
        self._threads = [threading.Thread(target=self._drain, args=(p, q),
                                          daemon=True)
                         for p, q in zip(self.paths, self._queues)]
        self.last = [[] for _ in self.paths]
        self.cpu_s = 0.0
        for t in self._threads:
            t.start()

    def _drain(self, path: str, q: queue.Queue) -> None:
        while True:
            try:
                fd = os.open(path, os.O_RDONLY)
            except OSError as exc:
                q.put(exc)
                return
            if self._stop:
                os.close(fd)
                return
            t0 = time.thread_time()
            try:
                fcntl.fcntl(fd, _F_SETPIPE_SZ, 1 << 20)
            except OSError:
                pass  # a pipe of the default size only costs more reads
            chunks, n = [], 0
            try:
                while True:
                    b = os.read(fd, 1 << 20)
                    if not b:
                        break
                    n += len(b)
                    chunks.append(b)
            finally:
                os.close(fd)
            q.put((n, chunks, time.thread_time() - t0))

    def collect(self, timeout: float = 300.0):
        got = []
        self.cpu_s = 0.0
        for k, q in enumerate(self._queues):
            item = q.get(timeout=timeout)
            if isinstance(item, Exception):
                raise item
            n, self.last[k], cpu = item
            self.cpu_s += cpu
            got.append(n)
        return got

    def last_text(self, k: int) -> str:
        return b"".join(self.last[k]).decode()

    def close(self) -> None:
        """Stop the reader threads (each waits in ``open``: a writer that
        opens and closes at once ends it) and remove the pipes."""
        self._stop = True
        for p, t in zip(self.paths, self._threads):
            for _ in range(1000):
                try:
                    os.close(os.open(p, os.O_WRONLY | os.O_NONBLOCK))
                except OSError as exc:
                    if exc.errno != errno.ENXIO:
                        raise
                    # ENXIO: the reader is not in open() yet, or is gone
                t.join(timeout=0.01)
                if not t.is_alive():
                    break
        for p in self.paths:
            os.unlink(p)
