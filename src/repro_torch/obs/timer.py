"""Device time of a step's phases: spans with a pair of CUDA events each."""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Iterator, List, Tuple

import torch

from repro_torch.obs.trace import Span, tracer


class PhaseTimer:
    """The spans of a train step's phases (or of a prefill's blocks, with
    ``cat`` "serve") and, on a CUDA device while the tracer is on, a pair
    of timing events around each. ``settle`` sets
    each span's ``device_ms`` once the step has synchronised: reading an
    event before then would wait on the device. The current stream is
    looked up once a step: the lookup costs more than a record."""

    def __init__(self, device: Any, cat: str = "train"):
        self.cuda = torch.device(device).type == "cuda"
        self.cat = cat
        self._pending: List[Tuple[Span, Any, Any]] = []
        self._stream: Any = None

    def _record(self) -> Any:
        if self._stream is None:
            self._stream = torch.cuda.current_stream()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self._stream)
        return ev

    @contextmanager
    def phase(self, name: str) -> Iterator[None]:
        tr = tracer()
        with tr.span(name, cat=self.cat) as sp:
            if not (self.cuda and tr.enabled):
                yield
                return
            start = self._record()
            yield
            self._pending.append((sp, start, self._record()))

    def settle(self) -> None:
        for sp, start, end in self._pending:
            sp.set("device_ms", start.elapsed_time(end))
        self._pending.clear()
        self._stream = None
