"""Spans the benchmark opens around the program's calls into a layer.

:class:`Spans` swaps a module attribute (a function the program calls
by that name) for a wrapper that, while ``on``, adds the call's host
seconds to a list under the span's name and, while ``profiling``, opens
a ``torch.profiler.record_function`` range of that name, so the
profiler attributes the kernels launched inside it.  A wrapper may also
time its calls on the device with CUDA events (``events``), kept with
each call's arguments for the reader.  :meth:`install` wraps what the
metrics declare; :meth:`restore` puts every attribute back.
"""

from __future__ import annotations

import importlib
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from typing import Callable, Dict, List, Optional

import torch


class Spans:
    def __init__(self):
        self.on = False
        self.profiling = False
        self.host: Dict[str, List[float]] = defaultdict(list)
        self.events: Dict[str, list] = defaultdict(list)
        self._patched: list = []

    def _range(self, name: str):
        if not self.profiling:
            return nullcontext()
        return torch.profiler.record_function(name)

    def wrap(self, owner, attr: str, name: str,
             keep: Optional[Callable] = None) -> None:
        """Time every call of ``owner.attr`` under ``name``; with ``keep``,
        also time it with CUDA events while profiling and keep
        ``keep(*args, **kw)`` beside them."""
        fn = getattr(owner, attr)
        spans = self

        def wrapper(*args, **kw):
            if not (spans.on or spans.profiling):
                return fn(*args, **kw)
            t0 = time.perf_counter()
            with spans._range(name):
                if keep is not None and spans.profiling:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    out = fn(*args, **kw)
                    end.record()
                    spans.events[name].append((start, end, keep(*args,
                                                                **kw)))
                else:
                    out = fn(*args, **kw)
            if spans.on:
                spans.host[name].append(time.perf_counter() - t0)
            return out

        self._patched.append((owner, attr, fn))
        setattr(owner, attr, wrapper)

    def install(self, wraps: list, objects: Dict[str, object],
                card: bool) -> None:
        """Wrap each declared call: ``(owner, attr, span[, keep])``, the
        owner a module's name or ``@name``, a runner's object of that
        name in ``objects`` (``@plane``: the run's ``MemoryPlane``);
        ``keep`` (events and arguments) only on a card.  A call whose
        owner this runner does not have is left alone."""
        for owner, attr, name, *keep in wraps:
            if owner.startswith("@"):
                target = objects.get(owner[1:])
            else:
                target = importlib.import_module(owner)
            if target is None or not hasattr(target, attr):
                continue
            self.wrap(target, attr, name,
                      keep=keep[0] if keep and card else None)

    @contextmanager
    def span(self, name: str):
        """A span the benchmark opens itself (a ``with`` block)."""
        t0 = time.perf_counter()
        with self._range(name):
            yield
        if self.on:
            self.host[name].append(time.perf_counter() - t0)

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._patched):
            setattr(owner, attr, fn)
        self._patched.clear()
