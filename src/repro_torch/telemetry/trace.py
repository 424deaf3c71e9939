"""Structured JSONL trace export.

The event simulator emits one record per protocol event (update sent /
applied, broadcast fired / applied); the cohort engines emit one
segment-summary record per eval segment plus a final ``report`` record.
Records are plain JSON objects with a ``kind`` discriminator so a trace
can be grepped/streamed without a schema registry.

``trace=`` accepts a path (opened and closed by the engine) or any
object with a ``write`` method (left open), so tests can pass an
``io.StringIO``.
"""
from __future__ import annotations

import json
from typing import Any, Dict, IO, Optional, Union

import numpy as np
import torch


_PLAIN = (int, float, str, bool, type(None))


def _coerce(obj: Any) -> Any:
    """Plain JSON values: tensors (0-d ones too) and numpy arrays and
    scalars become Python numbers and lists.  Plain values return first:
    a report record carries a row per client, and ``isinstance`` against
    ``torch.Tensor`` is slow."""
    if type(obj) in _PLAIN:
        return obj
    if isinstance(obj, dict):
        return {k: _coerce(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_coerce(x) for x in obj]
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


class JsonlTraceWriter:
    """Append-only JSONL sink; one ``emit`` per record."""

    def __init__(self, sink: Union[str, IO[str]]):
        if isinstance(sink, (str, bytes)):
            self._fh: IO[str] = open(sink, "w")
            self._own = True
        else:
            self._fh = sink
            self._own = False
        self.records = 0

    def emit(self, kind: str, **fields: Any) -> None:
        rec: Dict[str, Any] = {"kind": kind}
        rec.update(_coerce(fields))
        self._fh.write(json.dumps(rec) + "\n")
        self.records += 1

    def close(self) -> None:
        if self._own:
            self._fh.close()
        else:
            self._fh.flush()


def open_trace(trace, rank: int = 0) -> Optional[JsonlTraceWriter]:
    """None | path | file-like | JsonlTraceWriter -> writer or None.  Only
    rank 0 of a run cut over ranks writes: another ``rank`` gets None."""
    if trace is None or rank != 0:
        return None
    if isinstance(trace, JsonlTraceWriter):
        return trace
    return JsonlTraceWriter(trace)
