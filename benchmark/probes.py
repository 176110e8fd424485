"""What the benchmark reads from the program besides its stats: the gate
rows the device returned, and, in a traced run, spans around the calls
into each layer.

Both wrap functions of the program from outside for the length of a run
and put them back afterwards.  The rows are read where the program hands
them to its C++ finish (``native.GraphExporter.finish_bulk8`` and
``finish_bulk16``: contig indices, ``(B, V + 2)`` rows, V).  A span is
installed only where the function it wraps exists, so a program that moves
one leaves its gaps labelled by what the profiler saw instead.
"""

from __future__ import annotations

import functools
import zlib

import numpy as np

FINISHES = ("finish_bulk8", "finish_bulk16")
# (module path, attribute, span name) around the calls into each layer
SPANS = (
    ("alignasm_tpu_torch.runtime.scheduler", "_open_exporter",
     "pack (parse, build)"),
    ("alignasm_tpu_torch.runtime.scheduler", "_launch_buckets",
     "launch (export, copy, kernels)"),
    ("alignasm_tpu_torch.runtime.scheduler", "gather", "sync (wait, copy back)"),
    ("alignasm_tpu_torch.native", "GraphExporter.finish_bulk8", "finish"),
    ("alignasm_tpu_torch.native", "GraphExporter.finish_bulk16", "finish"),
    ("alignasm_tpu_torch.native", "GraphExporter.solve_remaining",
     "native solve"),
    ("alignasm_tpu_torch.native", "GraphExporter.write_results", "write"),
)


class _Patch:
    """Replaced attributes, put back by ``undo``."""

    def __init__(self):
        self._saved = []

    def wrap(self, owner, name: str, make):
        orig = getattr(owner, name)
        self._saved.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def undo(self) -> None:
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved.clear()


class RowCapture:
    """Every (contig indices, rows, V) the finish takes in a pass; a CRC of
    each pass, and the rows of the newest pass."""

    def __init__(self, exporter_cls):
        self._patch = _Patch()
        self._cur = []
        self.last = []
        for name in FINISHES:
            self._patch.wrap(exporter_cls, name, self._make)

    def _make(self, orig):
        @functools.wraps(orig)
        def finish(exporter, idx, dp, V, *args, **kwargs):
            self._cur.append((np.array(idx, np.int64), np.array(dp), int(V)))
            return orig(exporter, idx, dp, V, *args, **kwargs)
        return finish

    def end_pass(self) -> int:
        """The CRC of this pass's rows, in contig order; starts the next."""
        cur, self._cur = self._cur, []
        cur.sort(key=lambda t: int(t[0][0]) if len(t[0]) else -1)
        crc = 0
        for idx, dp, V in cur:
            crc = zlib.crc32(idx.tobytes(), crc)
            crc = zlib.crc32(np.ascontiguousarray(dp).tobytes(), crc)
            crc = zlib.crc32(V.to_bytes(4, "little"), crc)
        self.last = cur
        return crc

    def close(self) -> None:
        self._patch.undo()


class Spans:
    """``torch.profiler.record_function`` spans around the calls of
    ``SPANS`` that exist."""

    def __init__(self):
        import importlib

        from torch.profiler import record_function

        self._patch = _Patch()
        for mod_name, path, label in SPANS:
            try:
                owner = importlib.import_module(mod_name)
                *outer, name = path.split(".")
                for part in outer:
                    owner = getattr(owner, part)
                getattr(owner, name)
            except (ImportError, AttributeError):
                continue

            def make(orig, label=label):
                @functools.wraps(orig)
                def spanned(*args, **kwargs):
                    with record_function(label):
                        return orig(*args, **kwargs)
                return spanned
            self._patch.wrap(owner, name, make)

    def close(self) -> None:
        self._patch.undo()
