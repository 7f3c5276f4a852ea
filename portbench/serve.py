"""The serving runner: the port's engine under a closed loop of clients.

The engine is wired as ``repro_torch.launch.serve.build_engine`` wires
it: the ``Model``, a ``MemoryPlane`` with the configuration's
``hbm_pool_params`` on the same device, and a ``ServingEngine`` whose
KV pool the plane resizes every step.  The weights are the benchmark's
(drawn from the seed on the device), so the model is built here rather
than by ``build_engine``, which draws its own.

A run: the first request of every client (cut to stand for one under
way), ``warmup_steps`` untimed steps, then steps until ``seconds`` have
passed on the host's clock.  After each step the runner reads which
requests gained a token or completed (the step ends on the host's read
of the argmax, so a token's time is the step's end) and lets a client
whose request completed send its next one.  A traced run also times the
program's calls into its layers (:mod:`portbench.spans`) and profiles
``profile_steps`` more steps after the window.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from . import check, trace as T, traffic
from .port import build_model
from .spans import Spans
from .reference.model import layer_windows
from .yardstick import bound_s, decode_attention_work


@dataclass
class Rec:
    req: object
    client: int
    t_submit: float
    first_wave: bool
    n_out: int = 0
    t_first: Optional[float] = None
    t_last: Optional[float] = None
    t_done: Optional[float] = None


@dataclass
class ServeRun:
    kind: str = "serve"
    arch: dict = field(default_factory=dict)
    on_card: bool = False
    profiled_steps: int = 0
    setup_s: float = 0.0
    window_s: float = 0.0
    steps: int = 0
    tokens: int = 0
    fed: int = 0
    ctx: Dict[int, int] = field(default_factory=dict)   # window -> keys
    recs: List[Rec] = field(default_factory=list)
    t0: float = 0.0
    t1: float = 0.0
    longest_step_s: float = 0.0
    peak_window_bytes: int = 0
    peak_bytes: int = 0
    preemptions: int = 0
    spans: Optional[Spans] = None
    trace: Optional[T.Trace] = None
    b3: Optional[dict] = None
    stats: dict = field(default_factory=dict)

    def in_window(self, t: Optional[float]) -> bool:
        return t is not None and self.t0 < t <= self.t1


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def plane_params(cfg: dict):
    from repro_torch.configs.dynims import hbm_pool_params

    p = dict(cfg["plane"])
    p.pop("preset")
    hbm = p.pop("total_memory")
    return hbm_pool_params(hbm, total_memory=hbm, **p)


class Loop:
    """The engine and its clients."""

    def __init__(self, cfg: dict, mix: dict, seed: int,
                 device: torch.device, t_start: float):
        from repro_torch.core.plane import MemoryPlane, PlaneSpec
        from repro_torch.serving import ServingConfig, ServingEngine

        self.cfg, self.mix, self.device = cfg, mix, device
        self.arch = cfg["arch"]
        sv = cfg["serve"]
        self.model = build_model(cfg, seed, device)
        self.plane = MemoryPlane(PlaneSpec(params=plane_params(cfg),
                                           device=device))
        self.engine = ServingEngine(
            self.model, ServingConfig(max_batch=sv["max_batch"],
                                      max_len=sv["max_len"],
                                      block_tokens=sv["block_tokens"],
                                      cache_dtype=cfg["cache_dtype"]),
            device=device, plane=self.plane)
        self.clients = sv["max_batch"]
        self.windows = layer_windows(self.arch)
        if mix["max_total"] > sv["max_len"] - 1:
            raise ValueError(f"mix {mix['name']}: requests of "
                             f"{mix['max_total']} tokens pass the slots' "
                             f"{sv['max_len']} positions")
        self.stream = traffic.stream(mix, self.arch["vocab_size"], seed,
                                     self.clients)
        self.recs: Dict[int, Rec] = {}
        self.live: Dict[int, Rec] = {}
        self.log = StepLog(self.engine,
                           check.logit_ids(self.arch, seed, device),
                           self.arch["family"] == "moe")
        for c in range(self.clients):
            self.submit(c, t_start)

    def submit(self, client: int, now: float) -> None:
        d = next(self.stream)
        rid = self.engine.submit(d.prompt, d.max_new)
        rec = Rec(self.engine.queue[-1], client, now, d.first_wave)
        self.recs[rid] = rec
        self.live[rid] = rec

    def step(self, count: Optional[ServeRun] = None,
             spans: Optional[Spans] = None) -> float:
        """One engine step and the clients' reading of it; returns the
        step's end on the host's clock.  With ``count``, the step's
        tokens are added to it, and with ``spans`` the keys each fed
        token attended (for the FLOP count)."""
        eng = self.engine
        if spans is not None:
            with spans.span("pb.step"):
                eng.step()
        else:
            eng.step()
        now = time.perf_counter()
        if count is not None and spans is not None:
            self._count_context(count)
        done = []
        for rid, rec in self.live.items():
            n = len(rec.req.output)
            if n != rec.n_out:
                if rec.t_first is None:
                    rec.t_first = now
                if count is not None:
                    count.tokens += n - rec.n_out
                rec.n_out, rec.t_last = n, now
            if rid in eng.finished:
                rec.t_done = now
                done.append(rid)
        for rid in done:
            rec = self.live.pop(rid)
            self.submit(rec.client, now)
        if count is not None:
            count.steps += 1
        return now

    def _count_context(self, count: ServeRun) -> None:
        """Add the keys each token fed this step attended, per window."""
        windows = set(self.windows)
        for s in self.engine.slots:
            if s.request is None:
                continue
            count.fed += 1
            for w in windows:
                count.ctx[w] = count.ctx.get(w, 0) + (
                    min(s.ingested, w) if w else s.ingested)

    def close(self) -> None:
        self.log.close()
        self.engine = self.model = self.plane = None


class StepLog:
    """What the program's timed ``decode_step`` calls produced, for the
    check: a wrapper of ``decode_step`` notes which request and position
    each row of the step held, and keeps a sample of each row's logits,
    its values at ``ids`` (vocabulary ids drawn from the seed) and its
    largest; for a moe model ``repro_torch.models.moe.ROUTE_HOOK``
    observes each layer's routing.  The reference's logits are compared
    with these values (``logit_rms``); it follows the routing and judges
    it by its own router (``route_gap``)."""

    def __init__(self, engine, ids: torch.Tensor, moe: bool):
        import repro_torch.models.decode as D
        import repro_torch.models.moe as M

        self.engine, self.D, self.M, self.ids = engine, D, M, ids
        self.steps: list = []   # (rows, values (B, n+1), experts, keep)
        self._layers: list = []
        self._step = D.decode_step
        if moe:
            M.ROUTE_HOOK = self._hook
        D.decode_step = self._decode_step

    def _hook(self, experts, keep):
        self._layers.append((experts, keep))

    def _decode_step(self, *args, **kw):
        rows = [(s.request.rid, s.ingested) if s.request is not None
                else None for s in self.engine.slots]
        self._layers = []
        out = self._step(*args, **kw)
        logits = out[:, 0]
        values = torch.cat([logits.index_select(-1, self.ids),
                            logits.amax(-1, keepdim=True)], -1)
        ex = keep = None
        if self._layers:
            k = self._layers[0][0].shape[-1]
            ex = torch.stack([e.reshape(-1, k) for e, _ in self._layers])
            keep = torch.stack([c.reshape(-1, k) for _, c in self._layers])
        self.steps.append((rows, values, ex, keep))
        return out

    def close(self) -> None:
        self.M.ROUTE_HOOK = None
        self.D.decode_step = self._step
        self.engine = None

    def _hits(self, reqs: list, length: int):
        want = {r.req.rid: b for b, r in enumerate(reqs)}
        for rows, values, ex, keep in self.steps:
            hit = [(i, want[row[0]], row[1]) for i, row in enumerate(rows)
                   if row is not None and row[0] in want
                   and row[1] < length]
            if hit:
                yield hit, values, ex, keep

    def values(self, reqs: list, length: int) -> torch.Tensor:
        """(B, S, n+1): each sampled request's logit sample at each
        position it fed (the last pass over a position, after a
        requeue), NaN where none was fed."""
        out = torch.full((len(reqs), length, len(self.ids) + 1),
                         float("nan"))
        for hit, values, _, _ in self._hits(reqs, length):
            values = values.float().cpu()
            for i, b, pos in hit:
                out[b, pos] = values[i]
        return out

    def routes(self, reqs: list, length: int, layers: int, k: int):
        """(L, B, S, k): each sampled request's experts at each position
        it fed, -1 where none was fed; a pair the program dropped counts
        as no expert."""
        out = torch.full((layers, len(reqs), length, k), -1,
                         dtype=torch.long)
        for hit, _, ex, keep in self._hits(reqs, length):
            ex = torch.where(keep, ex, torch.full_like(ex, 10 ** 9)).cpu()
            for i, b, pos in hit:
                out[:, b, pos] = ex[:, i]
        return out


def _read_b3(spans: Spans, trace: Optional[T.Trace]) -> Optional[dict]:
    calls = spans.events.get("pb.b3", [])
    if not calls:
        return None
    torch.cuda.synchronize()
    event_s, bound = 0.0, 0.0
    for start, end, (lens, s, h, kv, hd, w, qb, kb) in calls:
        event_s += start.elapsed_time(end) / 1e3
        flops, n_bytes = decode_attention_work(lens.tolist(), s, h, kv, hd,
                                               w, qb, kb)
        bound += bound_s(flops, n_bytes)
    out = {"calls": len(calls), "bound_s": bound, "event_s": event_s,
           "profiled_s": None, "profiled_calls": 0}
    if trace is not None:
        out["profiled_calls"] = trace.count("decode_kernel")
        if out["profiled_calls"] == len(calls):
            out["profiled_s"] = trace.seconds("decode_kernel")
    return out


def run(cfg: dict, mix: dict, seed: int, seconds: float, traced: bool,
        device: torch.device, t_start: float, cell: str,
        fault=None, control: bool = False, wraps=()) -> tuple:
    """One run of a serving cell: (ServeRun, checks).  ``wraps``: the
    calls a traced run times (:meth:`Spans.install`); ``fault``, for
    the tests, is called with the loop before the window."""
    out = ServeRun(arch=cfg["arch"], on_card=device.type == "cuda")
    loop = Loop(cfg, mix, seed, device, time.perf_counter())
    if fault is not None:
        fault(loop)
    for _ in range(mix["warmup_steps"]):
        loop.step()
    _sync(device)
    # the plane keeps a bounded history: the warm-up's decisions, where
    # the pool grows from its first capacity, are read before the window
    # can push them out of it
    early = loop.plane.actions(node=loop.engine.node)
    if device.type == "cuda":
        out.peak_bytes = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    spans = None
    if traced:
        spans = out.spans = Spans()
        spans.install(wraps, {"plane": loop.plane}, out.on_card)
        spans.on = True
    gc.collect()
    gc.freeze()        # set-up's objects are not scanned in the window
    out.t0 = time.perf_counter()
    out.setup_s = out.t0 - t_start
    now = out.t0
    while now - out.t0 < seconds:
        last, now = now, loop.step(out, spans)
        out.longest_step_s = max(out.longest_step_s, now - last)
    out.t1 = now
    out.window_s = out.t1 - out.t0
    if traced:
        spans.on = False
        if mix.get("profile_steps"):
            spans.profiling = True
            with T.profiler(device) as prof:
                for _ in range(mix["profile_steps"]):
                    loop.step(spans=spans)
                _sync(device)
            spans.profiling = False
            out.profiled_steps = mix["profile_steps"]
            out.trace = T.read(prof)
            if device.type == "cuda":
                out.b3 = _read_b3(spans, out.trace)
        spans.restore()
    if device.type == "cuda":
        out.peak_window_bytes = torch.cuda.max_memory_allocated(device)
        out.peak_bytes = max(out.peak_bytes, out.peak_window_bytes)
    out.stats = loop.engine.stats()
    out.preemptions = out.stats["preemptions"]
    out.recs = list(loop.recs.values())
    seen = {id(a) for a in early}
    actions = early + [a for a in loop.plane.actions(node=loop.engine.node)
                       if id(a) not in seen]
    total = (float(torch.cuda.mem_get_info(device)[1])
             if device.type == "cuda" else None)
    log = loop.log
    loop.close()
    del loop
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check.serve(cfg, mix, seed, out, actions, total, device, cell,
                         control, log)
    return out, checks


def attempted_failed(run: ServeRun) -> tuple:
    """Requests the window worked on, and those the engine ended before
    their asked length (none in a sound run)."""
    worked = [r for r in run.recs
              if r.t_submit <= run.t1 and (r.t_done is None
                                           or r.t_done > run.t0)]
    failed = [r for r in worked if r.t_done is not None
              and r.n_out < r.req.max_new_tokens]
    return len(worked), len(failed)

