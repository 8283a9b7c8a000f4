# Copy of image_transformation_tpu/serving/server.py (host code copied; the device seam ported to torch).
"""Device-resident compose serving daemon (stdlib HTTP, no extra deps).

The daemon keeps bundles ingested and their object tensors on the device
(pipeline.engine.ComposeEngine), so a render request is: solve the
Flex-DSL on the host (microseconds) + one compose on the device (K1,
bit-exact vs PIL) + PNG encode.

    python -m image_transformation_tpu_torch.serving.server \\
        --bundles-root data [--host 127.0.0.1] [--port 8601] [--device cuda|cpu]

``--device`` defaults to cuda and raises when no card is present; "cpu"
runs every kernel's plain PyTorch version.

API (the JAX package's, request for request):
    GET  /healthz            -> {"ok": bool, "device": "...", "bundles": N,
        "backlog_age_s": S} — ok flips false while the oldest queued
        render exceeds the render deadline (a wedged device call strands
        the drain worker; renders 503 with RenderStuckError meanwhile);
        on a card "device" names it (torch.cuda.get_device_name)
    GET  /v1/bundles         -> [{"stem", "objects", "original": [w, h]}]
    POST /v1/render          -> image/png
        {"bundle": "<stem>", "ratio": "9:16",
         "layout": {"root": {...}}?,         # default: column of all objects
         "background": "solid"|"gradient"?,  # default solid
         "boxes_only": false?,               # true -> JSON placements, no PNG
         "format": "png"|"raw"?}             # raw -> octet-stream RGBA bytes
                                             #   (X-Raw-Shape header, no encode)
    POST /v1/render_batch    -> JSON {ratio: {canvas, boxes, png_b64}}
        {"bundle": "<stem>", "ratios": ["9:16", "1:1", ...],
         "layout": {"root": {...}}?,
         "background": "solid"|"gradient"?}
        All variants render in ONE fused device pass (the device solve,
        the background plane and K2; traced-table numerics <= 2/255 vs
        PIL — the per-request /v1/render path stays bit-exact).
    POST /v1/render_fleet    -> JSON {stem: {ratio: {...}} | {"error": ...}}
        {"bundles": ["<stem>", ...]?,   # default: every bundle under root
         "ratios": ["9:16", ...], "layout": {...}?, "background": ...?}
        One fused pass per bundle (each reusing the render_batch step
        cache), bundles overlapped across threads. Per-bundle failures are
        isolated.
    GET  /v1/stats           -> cache/coalescing counters + latency_ms
        (rolling p50/p95 per single-render phase: solve / queue /
        pipeline_wait / dispatch / device / device_residual / readback /
        encode — /v1/render responses carry the same split per request in
        an X-Render-Timings header) + dispatch_floor (the floor samples
        and their age) + device_calibration (per-engine, per-program
        amortized device ms and age)

Device seam (what differs from the JAX package):
- The per-request path composes through the engine: K1
  (ops/compose_kernels.fused_compose) on a CUDA device, its plain version
  on the CPU. Concurrent requests on one engine coalesce into ONE K1 call
  over B canvases (ComposeEngine.compose_many).
- /v1/render_batch and /v1/render_fleet run
  pipeline/fused.make_fused_render(kernel="pallas"), which is K2. A K2
  failure raises to the request (HTTP 500); no fallback is latched, and the
  next request tries K2 again.
- All device work runs on the calling thread's current stream; no side
  stream is created, so the drain worker and the handler threads stay
  ordered on one stream. Rows come back through a pinned host buffer each
  (``copy_(non_blocking=True)``) and a CUDA event, waited on where the
  row is needed; on the CPU a readback is a plain copy.
- The dispatch floor is a no-op on the service's device,
  ``(tiny + 1)[0, 0].item()``: about 0.03 ms on an H100. Its samples,
  TTL and the /v1/stats keys are the JAX package's.
- No environment variable is read: the render deadline and the RGB
  readback are module constants, and the manifest defaults to
  ~/.cache/image_transformation_tpu_torch/serving_steps.json
  (``manifest_path`` overrides it).

Concurrency/caching design:
- engine/step/input construction is serialized per cache key (one thread
  builds, the rest wait);
- the batch-step cache key canonicalizes the ratio set (sorted, deduped),
  so request order and duplicates share one step;
- device inputs (object tensors) are cached separately from the steps and
  shared across every ratio-set/background entry of a bundle;
- built batch-step keys persist to a manifest so a restarted daemon can
  rebuild them before traffic.

Shutdown: :meth:`ComposeService.close` stops the service's threads (the
drain workers, the warm start, the render_fleet pools) and joins them; a
render after it raises. ``serve()`` closes the service it built in the
server's ``server_close()``, and an ``atexit`` handler closes every
service still open when the interpreter exits, so no thread of the
service is inside torch while the interpreter finalizes (a thread in
torch then aborts the process).
"""

from __future__ import annotations

import argparse
import atexit
import json
import sys
import threading
import time
import weakref
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device

#: recalibrate the dispatch floor at idle once it is older than this
_DISPATCH_FLOOR_TTL_S = 60.0
#: longest a thread waits for another thread's floor refresh before it
#: goes on with the floor it has
_FLOOR_WAIT_S = 1.0
#: per-program amortized device calibration: refresh at idle once older
#: than this. The chain length adapts to a time budget, reps = budget /
#: estimated device ms, clamped to [16, 128], so a request arriving
#: mid-refresh waits a bounded ~2 x budget.
_CALIB_TTL_S = 120.0
_CALIB_REPS_MAX = 128
_CALIB_REPS_MIN = 16
_CALIB_BUDGET_MS = 250.0

#: bounded render wait: a caller whose render has not settled after this
#: long gets a RenderStuckError (HTTP 503); the drain worker itself cannot
#: be interrupted, so /healthz reports ok=false with the backlog age while
#: the wedge lasts
_RENDER_WAIT_S = 300.0

#: opaque-canvas renders read back RGB only (alpha provably 255,
#: re-attached on the host): 25% fewer readback bytes
_RGB_READBACK = True

#: how long ComposeService.close() waits for the service's threads by
#: default (at most one merge, one idle refresh step and one fused pass
#: are in flight once the stop flag is set)
_CLOSE_TIMEOUT_S = 60.0


class RenderStuckError(RuntimeError):
    """A render waited past _RENDER_WAIT_S: the device pipeline is wedged
    or overloaded far beyond its deadline."""


class ServiceClosedError(RuntimeError):
    """A render asked of a service after :meth:`ComposeService.close`."""

    def __init__(self):
        super().__init__("the compose service is closed")


def _join_all(threads, deadline: float) -> None:
    """Join each thread by ``deadline`` (perf_counter seconds); raise,
    naming every thread still alive after it."""
    for t in threads:
        t.join(max(0.0, deadline - time.perf_counter()))
    alive = [t.name for t in threads if t.is_alive()]
    if alive:
        raise RuntimeError(f"compose service threads still running after close(): {alive}")


def _measure_floor_samples(device: torch.device, n: int = 5) -> List[float]:
    """``n`` no-op dispatch + one-element fence round trips (ms) on
    ``device``: ``(tiny + 1)[0, 0].item()`` on an [8, 128] int32 tensor.
    No lock held."""
    tiny = torch.zeros((8, 128), dtype=torch.int32, device=device)
    (tiny + 1)[0, 0].item()  # warm
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        (tiny + 1)[0, 0].item()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


class DispatchFloor:
    """Rolling dispatch + fence floor of one device (ms): the median of
    recent no-op round trips, re-measured at idle once older than
    ``_DISPATCH_FLOOR_TTL_S``. One per service; its coalescers share it.

    Measurement happens outside the lock. A refresh that raises keeps the
    previous floor with its age bumped, so a failing device is not
    retried hot. While a refresh is in flight the floor does not count as
    stale, so an idle drain worker retires instead of asking again; a
    thread that still asks for a refresh meanwhile waits for it, bounded
    by ``_FLOOR_WAIT_S``, and never loops on the stale floor.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self._cond = threading.Condition()
        self._floor_ms: Optional[float] = None
        self._age = 0.0
        self._refreshing = False
        #: recent no-op dispatch+fence samples (ms)
        self._samples: deque = deque(maxlen=64)

    def get(self, refresh: bool = False) -> float:
        """The working floor. ``refresh=True`` re-measures a stale floor
        (ask only at idle). Only the first calibration, when no floor
        exists yet, blocks until a floor exists."""
        with self._cond:
            while True:
                have = self._floor_ms
                stale = time.perf_counter() - self._age > _DISPATCH_FLOOR_TTL_S
                if have is not None and not (refresh and stale):
                    return have
                if self._refreshing:
                    self._cond.wait(timeout=_FLOOR_WAIT_S)
                    if have is not None:
                        return self._floor_ms
                    continue
                self._refreshing = True
                break
        samples: List[float] = []
        err: Optional[BaseException] = None
        try:
            samples = _measure_floor_samples(self.device)
        except Exception as e:  # noqa: BLE001 - handled under the lock below
            err = e
        with self._cond:
            self._refreshing = False
            # the age bumps on both outcomes: a failed refresh is not
            # retried by the next staleness check
            self._age = time.perf_counter()
            if samples:
                self._samples.extend(samples)
                recent = sorted(list(self._samples)[-15:])
                self._floor_ms = round(recent[len(recent) // 2], 3)
            self._cond.notify_all()
            if self._floor_ms is None:
                raise err if err is not None else RuntimeError(
                    "dispatch-floor calibration produced no samples"
                )
            return self._floor_ms

    def stale(self) -> bool:
        """A floor exists, is older than the TTL, and nobody refreshes it."""
        with self._cond:
            return (
                self._floor_ms is not None
                and not self._refreshing
                and time.perf_counter() - self._age > _DISPATCH_FLOOR_TTL_S
            )

    def info(self) -> Dict:
        """Public snapshot: working floor (ms), sample percentiles, sample
        count, and seconds since the last refresh."""
        with self._cond:
            samples = list(self._samples)
            floor = self._floor_ms
            age = time.perf_counter() - self._age if floor is not None else None
        info: Dict = {
            "floor_ms": floor,
            "age_s": round(age, 1) if age is not None else None,
            "samples": len(samples),
        }
        if samples:
            s = sorted(samples)
            info["p50_ms"] = round(s[len(s) // 2], 3)
            info["p95_ms"] = round(s[min(len(s) - 1, int(len(s) * 0.95))], 3)
        return info


class _HostCopy:
    """The host copy of a device tensor, started without blocking.

    On a CUDA device the tensor (made contiguous on the device) is copied
    into a pinned host buffer with ``non_blocking=True`` and a CUDA event
    is recorded behind the copy on the current stream; :meth:`numpy` waits
    on that event. On the CPU it is a plain copy."""

    __slots__ = ("host", "event")

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            src = t.contiguous()
            self.host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            self.host.copy_(src, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.host = t.contiguous()
            self.event = None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class _DoneEvent:
    """Marks the work queued so far on ``device``'s current stream;
    :meth:`wait` returns once it has run (at once on the CPU)."""

    __slots__ = ("event",)

    def __init__(self, device: torch.device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(device))

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def _rgba_from_rgb(rgb):
    """Re-attach the constant alpha plane an opaque-canvas RGB readback
    dropped (host memcpy — callers see identical RGBA)."""
    out = np.empty((*rgb.shape[:-1], 4), np.uint8)
    out[..., :3] = rgb
    out[..., 3] = 255
    return out


class _Coalescer:
    """Per-engine render queue: while one dispatch is in flight, arriving
    compatible requests queue up and ride the next dispatch together.

    A short-lived worker thread drains the queue (spawned on demand, exits
    when idle), so no request thread is drafted into serving later
    arrivals. :meth:`close` sets the stop flag: the worker settles what
    is queued or in flight, runs no further idle refresh, and retires.

    Requests with identical placements are DEDUPED (singleflight): one
    compose leg, one row readback, and one shared PNG encode serve every
    duplicate in the merge. The merge cap applies to UNIQUE placement
    sets, so a burst of duplicates never splinters into many dispatches."""

    #: unique placement sets merged per dispatch (padded to a power of
    #: two); duplicates ride free on top of the cap
    MAX_MERGE = 8

    def __init__(self, engine, floor: DispatchFloor, owner=None):
        self.engine = engine
        self.floor = floor
        # the service this queue belongs to; a running worker holds it, so
        # the service (and its atexit registration) outlives its callers
        self._owner = weakref.ref(owner) if owner is not None else None
        self._lock = threading.Lock()
        self._pending: List[tuple] = []
        self._worker: Optional[threading.Thread] = None
        self._closed = False
        self.requests = 0
        self.dispatches = 0
        self.deduped = 0
        # completion time of the previous merge (worker thread only): under
        # pipelined load merge k+1's device work cannot start before merge
        # k's finishes, and that wait is pipeline_wait_ms, not device_ms
        self._prev_done: Optional[float] = None
        # Per-program amortized device calibration: at idle the drain
        # worker runs engine.measure_device_ms on the most recent
        # placements of each merge-program key, and merges publish that as
        # device_ms with the single-shot residual kept alongside. Both
        # dicts are worker-thread-owned; values are replaced whole.
        self._calib: Dict[tuple, dict] = {}
        self._calib_pending: Dict[tuple, list] = {}
        # dispatch times of merges still in flight: a ticket swallowed by a
        # wedged merge has already left _pending, so the backlog-age wedge
        # signal counts unfinished merges too
        self._merge_t0s: List[float] = []

    @staticmethod
    def _placements_key(placements) -> str:
        """Canonical identity of a placement set (dict order insensitive)."""
        return json.dumps(
            placements, sort_keys=True, separators=(",", ":"), default=str
        )

    def render(self, placements) -> "np.ndarray":
        """Compose one placement set; returns the np.uint8 [H, W, 4] image."""
        return self.render_timed(placements)[0]

    def render_timed(self, placements):
        """Compose one placement set; returns (image, timings_ms) where
        timings_ms splits queue wait / dispatch floor / device compose /
        readback. Dispatch, device and readback times are per dispatch:
        requests merged into one dispatch share the same figures."""
        ticket = {"event": threading.Event(), "enqueued": time.perf_counter()}
        key = self._placements_key(placements)
        with self._lock:
            if self._closed:
                raise ServiceClosedError()
            self.requests += 1
            self._pending.append((placements, ticket, key))
            # worker retirement happens under this same lock (see _drain),
            # so either it is live and will see our item, or it is None
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._drain, daemon=True, name="coalescer-drain",
                    args=(self._owner and self._owner(),),
                )
                self._worker.start()
        if not ticket["event"].wait(timeout=_RENDER_WAIT_S):
            with self._lock:
                depth = len(self._pending)
                alive = self._worker is not None
            raise RenderStuckError(
                f"render not settled within {_RENDER_WAIT_S:.0f}s "
                f"(queue depth {depth}, drain worker "
                f"{'alive' if alive else 'retired'}, backlog age "
                f"{self.backlog_age_s():.0f}s) — device pipeline wedged "
                "or overloaded"
            )
        if "error" in ticket:
            raise ticket["error"]
        return ticket["result"], ticket.get("timings", {})

    def close(self, timeout: float = _CLOSE_TIMEOUT_S) -> None:
        """Set the stop flag and join the drain worker; raises, naming the
        worker, if it is still alive after ``timeout`` seconds."""
        with self._lock:
            self._closed = True
            worker = self._worker
        if worker is not None:
            _join_all([worker], time.perf_counter() + timeout)

    def backlog_age_s(self) -> float:
        """Age of the oldest unsettled work — queued requests AND merges
        dispatched but never completed — 0.0 when idle; the wedge signal
        /healthz and /v1/stats publish."""
        now = time.perf_counter()
        with self._lock:
            ages = [now - t["enqueued"] for _, t, _ in self._pending]
            ages += [now - t0 for t0 in self._merge_t0s]
        return max(ages, default=0.0)

    def _drain(self, owner=None) -> None:
        # ``owner`` (the service) is only held: the thread drops it on exit
        # ONE merge pipelined against the previous completion: batch k+1
        # is dispatched (launches return at once on a card) BEFORE batch
        # k's readback, so the device computes k+1 while the host drains k.
        inflight = None
        while True:
            with self._lock:
                batch: List[tuple] = []
                uniq: set = set()
                for item in self._pending:
                    if item[2] not in uniq:
                        if len(uniq) >= self.MAX_MERGE:
                            break
                        uniq.add(item[2])
                    batch.append(item)
                del self._pending[: len(batch)]
                if not batch and inflight is None:
                    # closed: everything queued is settled, so no refresh
                    floor_stale = not self._closed and self.floor.stale()
                    calib_key = None if self._closed else self._stale_calib_key()
                    if not floor_stale and calib_key is None:
                        self._worker = None  # retire atomically with the check
                        return
                    idle_refresh = True
                else:
                    idle_refresh = False
            if idle_refresh:
                # the queue is empty and nothing is in flight: the one safe
                # time to re-measure the floor and the calibrations; ONE
                # step per loop so the queue is re-checked in between
                try:
                    if floor_stale:
                        self.floor.get(refresh=True)
                    elif calib_key is not None:
                        self._refresh_calibration(calib_key)
                except Exception:  # noqa: BLE001 - never strand the worker
                    # a failed refresh keeps the old floor/calibration with
                    # its age bumped; the worker must survive to drain and
                    # retire, or every later render() waits on a dead queue
                    pass
                continue
            nxt = None
            if batch:
                try:
                    nxt = self._start(batch)
                except Exception as e:  # noqa: BLE001 - never strand
                    self._settle_unsettled([t for _, t, _ in batch], e)
            if inflight is not None:
                try:
                    self._complete(inflight)
                except Exception as e:  # noqa: BLE001 - never strand
                    self._settle_unsettled(
                        [t for g in inflight[0] for t in g[1]], e
                    )
            inflight = nxt

    def _note_calib_target(self, key: tuple, sets: list) -> None:
        """Remember the most recent placements dispatched under this
        merge-program key so the idle calibration measures the program
        traffic actually exercises (worker thread only; bounded)."""
        if key not in self._calib_pending and len(self._calib_pending) >= 8:
            self._calib_pending.pop(next(iter(self._calib_pending)))
        self._calib_pending[key] = sets

    def _stale_calib_key(self) -> Optional[tuple]:
        """Oldest merge-program key due for device calibration, or None.
        Cheap (no device work) — called under the queue lock."""
        worst, worst_age = None, _CALIB_TTL_S
        now = time.perf_counter()
        for key in self._calib_pending:
            ent = self._calib.get(key)
            age = now - ent["at"] if ent else float("inf")
            if age > worst_age:
                worst, worst_age = key, age
        return worst

    def _refresh_calibration(self, key) -> None:
        """Amortized device time for ``key``'s program at its most recent
        placements (worker thread, idle only). Failures keep the old value
        with the age bumped, so a failing device is not retried hot."""
        sets = self._calib_pending.get(key)
        if sets is None:
            return
        old = self._calib.get(key) or {}
        try:
            floor = self.floor.get()
            # size the chain to the time budget: a coarse unsubtracted
            # probe (an over-estimate, never stored as a sample) unless a
            # prior estimate exists
            est = old.get("device_ms")
            if est is None:
                if self._stop_refresh():
                    return
                est = self.engine.measure_device_ms(
                    sets, reps=_CALIB_REPS_MIN, floor_ms=0.0
                )
            reps = min(_CALIB_REPS_MAX, max(
                _CALIB_REPS_MIN, int(_CALIB_BUDGET_MS / max(est, 0.05))
            ))
            # two readings per refresh; each is an upper bound (the fence
            # and host work only add), so the published figure is the MIN
            # over the rolling sample history
            samples = list(old.get("samples", []))[-6:]
            for _ in range(2):
                samples.append(round(self.engine.measure_device_ms(
                    sets, reps=reps, floor_ms=floor
                ), 3))
                if self._stop_refresh():
                    break  # yield to real traffic or close(); the next idle refines
            self._calib[key] = {
                "device_ms": min(samples), "at": time.perf_counter(),
                "reps": reps, "merge_programs": key[1],
                "samples": samples,
            }
        except Exception:  # noqa: BLE001 - keep old value, bump age
            self._calib[key] = dict(
                old, at=time.perf_counter(), failed=True
            ) if old else {
                "device_ms": None, "at": time.perf_counter(), "failed": True,
            }
            raise

    def _stop_refresh(self) -> bool:
        """A request is queued or close() was called: an idle refresh
        stops at its next step."""
        with self._lock:
            return bool(self._pending) or self._closed

    def calibration_info(self) -> Dict[str, dict]:
        """Public snapshot of the per-program device calibrations."""
        now = time.perf_counter()
        out = {}
        for key, ent in list(self._calib.items()):
            out["x".join(str(k) for k in key)] = {
                "device_ms": ent.get("device_ms"),
                "age_s": round(now - ent["at"], 1),
                "reps": ent.get("reps"),
                "samples": list(ent.get("samples", [])),
                "failed": bool(ent.get("failed", False)),
            }
        return out

    @staticmethod
    def _settle_unsettled(tickets, err) -> None:
        # only tickets not already settled — a request whose render
        # completed (or failed on its own) keeps its real outcome
        for ticket in tickets:
            if "result" not in ticket and "error" not in ticket:
                ticket["error"] = err
                ticket["event"].set()

    def _start(self, batch: List[tuple]):
        """Validate and dispatch one merged compose; returns the in-flight
        state ``(groups, rows, done, t0, ckey)`` — groups is a list of
        ``(placements, tickets)`` aligned with rows (host copies, started
        here), each group one UNIQUE placement set and every ticket that
        requested it; ``done`` marks the end of the compose — or None if
        nothing survived validation."""
        # group duplicates first, then validate once per unique set (the
        # engine's OWN check): one malformed placement set fails alone,
        # with all its duplicates, and does not poison its batch-mates
        order: List[str] = []
        by_key: Dict[str, tuple] = {}
        for placements, ticket, key in batch:
            if key not in by_key:
                order.append(key)
                by_key[key] = (placements, [ticket])
            else:
                by_key[key][1].append(ticket)
        groups = []
        for key in order:
            placements, tickets = by_key[key]
            try:
                self.engine.validate_placements(placements)
                groups.append((placements, tickets))
            except Exception as e:  # noqa: BLE001
                for ticket in tickets:
                    ticket["error"] = e
                    ticket["event"].set()
        if not groups:
            return None
        self.deduped += sum(len(t) - 1 for _, t in groups)

        sets = [placements for placements, _ in groups]
        t0 = None
        try:
            t0 = time.perf_counter()
            with self._lock:
                self._merge_t0s.append(t0)
            if len(sets) == 1:
                ckey = ("single", 1)
                self._note_calib_target(ckey, [sets[0]])
                rows = [self.engine.compose(sets[0])]
            else:
                # pad to the next power of two so merge sizes share a few
                # program keys; extra legs repeat request 0 and are never
                # read back
                full = 1 << (len(sets) - 1).bit_length()
                padded = sets + [sets[0]] * (full - len(sets))
                ckey = ("many", full)
                self._note_calib_target(ckey, padded)
                dev = self.engine.compose_many(padded)
                rows = [dev[i] for i in range(len(sets))]
            done = _DoneEvent(self.engine.device)
            if _RGB_READBACK and getattr(self.engine, "opaque_output", False):
                # Opaque canvas: PIL's alpha_composite leaves alpha == 255
                # on every pixel, so only the RGB planes are read back and
                # _complete re-attaches alpha; callers get identical RGBA
                rows = [r[..., :3] for r in rows]
            return (groups, [_HostCopy(r) for r in rows], done, t0, ckey)
        except Exception as e:  # noqa: BLE001 - propagate to every waiter
            # and drop the in-flight marker, or backlog_age_s would climb
            # forever and /healthz stay unhealthy
            self._settle_unsettled([t for _, ts in groups for t in ts], e)
            if t0 is not None:
                self._drop_merge_t0(t0)
            return None

    def _drop_merge_t0(self, t0: float) -> None:
        with self._lock:
            try:
                self._merge_t0s.remove(t0)
            except ValueError:
                pass

    def _complete(self, inflight) -> None:
        # The compose's end is fenced by its event, so the row copies past
        # that point are pure transfer. Tickets settle PER ROW as their
        # copies land. Under pipelined load the device cannot start this
        # merge before the PREVIOUS merge's compute finishes; that interval
        # is pipeline_wait_ms, taken from the previous merge's fence.
        groups, rows, done, t0, ckey = inflight
        prev_done = self._prev_done
        try:
            self._complete_inner(groups, rows, done, t0, ckey, prev_done)
        finally:
            self._drop_merge_t0(t0)

    def _complete_inner(self, groups, rows, done, t0, ckey, prev_done):
        try:
            done.wait()
            t1 = time.perf_counter()
            first = rows[0].numpy()
            t_first = time.perf_counter()
            self._prev_done = t1
            self.dispatches += 1
            floor_ms = self.floor.get()
            start_eff = t0 if prev_done is None else max(t0, prev_done)
            raw_ms = (t1 - start_eff) * 1e3
            residual_ms = round(max(0.0, raw_ms - floor_ms), 2)
            # device_ms: the idle-time amortized calibration of THIS merge
            # program when one exists, else the single-shot residual; a
            # failed refresh keeps (and serves) the old value
            calib = self._calib.get(ckey)
            calibrated = calib.get("device_ms") if calib else None
            base = {
                "dispatch_ms": round(min(floor_ms, raw_ms), 2),
                "device_ms": (
                    calibrated if calibrated is not None else residual_ms
                ),
                "device_residual_ms": residual_ms,
                "device_source": (
                    "calibrated" if calibrated is not None else "residual"
                ),
                "pipeline_wait_ms": round(
                    max(0.0, (start_eff - t0) * 1e3), 2
                ),
                "merged": sum(len(ts) for _, ts in groups),
                "unique": len(groups),
            }
            if calibrated is not None:
                base["calibration_age_s"] = round(
                    time.perf_counter() - calib["at"], 1
                )
            for i, (_, tickets) in enumerate(groups):
                img = first if i == 0 else rows[i].numpy()
                t_i = t_first if i == 0 else time.perf_counter()
                if img.shape[-1] == 3:  # RGB readback: re-attach alpha
                    img = _rgba_from_rgb(img)
                readback_ms = round((t_i - t1) * 1e3, 2)
                # duplicates share one row readback AND one PNG encode: the
                # handler encodes under the share's lock, followers reuse it
                share = {"lock": threading.Lock()} if len(tickets) > 1 else None
                for ticket in tickets:
                    ticket["result"] = img
                    ticket["timings"] = dict(
                        base,
                        readback_ms=readback_ms,
                        queue_ms=round(
                            (t0 - ticket["enqueued"]) * 1e3, 2
                        ),
                    )
                    if share is not None:
                        ticket["timings"]["_png_share"] = share
                    ticket["event"].set()
        except Exception as e:  # noqa: BLE001 - propagate to every waiter
            self._settle_unsettled([t for _, ts in groups for t in ts], e)


#: every service not yet closed; the atexit handler below closes them
_LIVE_SERVICES: "weakref.WeakSet[ComposeService]" = weakref.WeakSet()


@atexit.register
def _close_live_services() -> None:
    """Close every open service before the interpreter finalizes: a drain
    worker still inside torch then would abort the process."""
    for service in list(_LIVE_SERVICES):
        try:
            service.close()
        except RuntimeError as e:
            print(f"[serving] at exit: {e}", file=sys.stderr)


class ComposeService:
    """Bundle/engine cache + render entry points (thread-safe), on one
    device (``device``, default "cuda"; raises without a card).

    :meth:`close` stops and joins the service's threads; a service never
    closed is closed at interpreter exit."""

    MAX_BATCH_STEPS = 32
    MAX_DEVICE_INPUTS = 8
    MANIFEST_RECORDS = 64

    def __init__(self, bundles_root: Path, manifest_path: Optional[Path] = None,
                 device="cuda"):
        self.root = Path(bundles_root)
        self.device = resolve_device(str(device))
        self.floor = DispatchFloor(self.device)
        self._lock = threading.Lock()
        self._key_locks: Dict[tuple, threading.Lock] = {}
        self._bundles: Dict[str, object] = {}
        self._engines: Dict[Tuple[str, int, int, str], object] = {}
        self._coalescers: Dict[Tuple[str, int, int, str], _Coalescer] = {}
        self._batch_steps: Dict[tuple, tuple] = {}
        self._device_inputs: Dict[tuple, tuple] = {}
        # rolling single-render phase samples (ms) for /v1/stats
        self._latency_lock = threading.Lock()
        self._latency: Dict[str, deque] = {
            k: deque(maxlen=512)
            for k in ("solve", "queue", "pipeline_wait", "dispatch",
                      "device", "device_residual", "readback", "encode")
        }
        self.manifest_path = Path(
            manifest_path
            or Path.home() / ".cache" / "image_transformation_tpu_torch"
            / "serving_steps.json"
        )
        self._closed = False
        # threads close() joins besides the drain workers: the warm start,
        # and (pool, futures) of render_fleet_iter calls not yet joined
        self._warm_threads: List[threading.Thread] = []
        self._fleet_pools: List[tuple] = []
        _LIVE_SERVICES.add(self)

    def _check_open(self) -> None:
        if self._closed:
            raise ServiceClosedError()

    def close(self, timeout: float = _CLOSE_TIMEOUT_S) -> None:
        """Stop the service's threads and join them; idempotent.

        Renders asked after this raise :class:`ServiceClosedError`. Work
        already queued or in flight is settled first: each drain worker
        retires without a further idle refresh, the warm start stops after
        its current step, and render_fleet pools drop their queued bundles
        and finish the running ones. Raises, naming the threads, if any is
        still alive after ``timeout`` seconds."""
        from concurrent.futures import wait

        deadline = time.perf_counter() + timeout
        with self._lock:
            self._closed = True
            coalescers = list(self._coalescers.values())
            warm = list(self._warm_threads)
            pools = list(self._fleet_pools)
        _join_all(warm, deadline)
        for pool, futures in pools:
            pool.shutdown(wait=False, cancel_futures=True)
            wait(futures, timeout=max(0.0, deadline - time.perf_counter()))
            running = [f for f in futures if not f.done()]
            if running:
                raise RuntimeError(
                    f"render_fleet workers still running after close(): {len(running)}"
                )
            pool.shutdown(wait=True)  # its threads exit once their futures are done
        for co in coalescers:
            co.close(max(0.0, deadline - time.perf_counter()))
        with self._lock:
            self._warm_threads.clear()
            self._fleet_pools[:] = [e for e in self._fleet_pools if e not in pools]
        _LIVE_SERVICES.discard(self)

    def device_name(self) -> str:
        """The service's device, with the card's name on CUDA."""
        if self.device.type == "cuda":
            return f"{self.device} ({torch.cuda.get_device_name(self.device)})"
        return str(self.device)

    def _key_lock(self, kind: str, key) -> threading.Lock:
        # striped: a bounded lock table (user-supplied layout JSON never
        # becomes a dict key that outlives its cache entry); a collision
        # merely serializes two unrelated builds
        slot = (kind, hash(key) & 0xFF)
        with self._lock:
            return self._key_locks.setdefault(slot, threading.Lock())

    def list_bundles(self):
        """Cheap listing: results.json + the PNG header only (no object
        decode — a liveness probe must not ingest every bundle)."""
        from PIL import Image

        out = []
        for child in sorted(self.root.iterdir()):
            if (child / "results.json").exists() and (child / "background.png").exists():
                items = json.loads((child / "results.json").read_text())
                with Image.open(child / "background.png") as im:
                    size = list(im.size)  # header read only
                out.append({
                    "stem": child.name,
                    "objects": len(items),
                    "original": size,
                })
        return out

    def _bundle(self, stem: str):
        from ..core.bundle import load_bundle

        with self._lock:
            bundle = self._bundles.get(stem)
        if bundle is not None:
            return bundle
        with self._key_lock("bundle", stem):
            with self._lock:
                bundle = self._bundles.get(stem)
            if bundle is None:
                bundle = load_bundle(self.root / stem)
                with self._lock:
                    bundle = self._bundles.setdefault(stem, bundle)
            return bundle

    def _background(self, bundle) -> torch.Tensor:
        """The bundle's background as a uint8 [H, W, 4] tensor on the
        service's device."""
        return torch.from_numpy(np.array(bundle.background, np.uint8)).to(self.device)

    def _canvas(self, bundle, canvas_size, background: str) -> torch.Tensor:
        from ..ops.background import synthesize_canvas

        return synthesize_canvas(
            self._background(bundle), canvas_size[0], canvas_size[1], background,
        )

    def _engine(self, stem: str, canvas_size, background: str):
        """The engine of (bundle, canvas size, background), built once.

        JAX's service also starts a thread that pre-compiles the
        coalescer's merge sizes (``_warm_merge_buckets``); the port has no
        such thread. Torch compiles nothing per shape and K1 builds once,
        at first use. That thread also wrote into the engine's call cache
        while the coalescer used it."""
        from ..pipeline.engine import ComposeEngine

        key = (stem, canvas_size[0], canvas_size[1], background)
        with self._lock:
            engine = self._engines.get(key)
        if engine is not None:
            return engine
        # serialize per key: exactly one thread builds and uploads the
        # engine, concurrent first requests wait
        with self._key_lock("engine", key):
            with self._lock:
                engine = self._engines.get(key)
            if engine is None:
                bundle = self._bundle(stem)
                canvas = self._canvas(bundle, canvas_size, background)
                engine = ComposeEngine(bundle.to_arrays(), canvas, self.device)
                with self._lock:
                    engine = self._engines.setdefault(key, engine)
                    self._coalescers.setdefault(key, _Coalescer(engine, self.floor, self))
            return engine

    def _coalescer(self, stem: str, canvas_size, background: str) -> _Coalescer:
        key = (stem, canvas_size[0], canvas_size[1], background)
        self._engine(stem, canvas_size, background)
        with self._lock:
            # checked under the lock close() takes: a coalescer handed out
            # here is one that close() closes
            self._check_open()
            return self._coalescers[key]

    def coalescing_stats(self) -> Dict[str, int]:
        """Totals across engines: requests served vs device dispatches vs
        requests that rode a duplicate's render (singleflight)."""
        with self._lock:
            cos = list(self._coalescers.values())
        return {
            "requests": sum(c.requests for c in cos),
            "dispatches": sum(c.dispatches for c in cos),
            "deduped": sum(c.deduped for c in cos),
        }

    def backlog_age_s(self) -> float:
        """Oldest unsettled queued render across every engine (0.0 when
        all queues are empty) — the device-pipeline wedge signal."""
        with self._lock:
            cos = list(self._coalescers.values())
        return max((c.backlog_age_s() for c in cos), default=0.0)

    @staticmethod
    def _resolve_layout(bundle, layout: Optional[Dict]) -> Dict:
        """Default column-of-all-objects layout + 'root' validation (shared
        by the per-request and batch endpoints)."""
        if layout is None:
            children = [
                {"object_id": oid, "name": bundle.id_to_label().get(oid, "")}
                for oid in bundle.object_ids()
            ]
            layout = {"root": {"type": "flex", "direction": "column",
                               "children": children}}
        if "root" not in layout:
            raise ValueError("layout must contain 'root'")
        return layout

    def solve(self, stem: str, ratio: str, layout: Optional[Dict] = None):
        """Solve only (no device work): returns (placements, canvas_size)."""
        from ..layout.canvas import compute_canvas_size
        from ..layout.flex import solve_flex

        bundle = self._bundle(stem)
        canvas_size = compute_canvas_size(bundle.background.size, ratio, verbose=False)
        layout = self._resolve_layout(bundle, layout)
        placements = solve_flex(layout["root"], canvas_size, bundle.sizes())
        return placements, canvas_size

    def render(
        self,
        stem: str,
        ratio: str,
        layout: Optional[Dict] = None,
        background: str = "solid",
    ):
        """Returns (placements, canvas_size, composed np.uint8 [H, W, 4]).

        Requests route through the engine's coalescer: under concurrent
        load, queued compatible requests merge into one K1 call.
        """
        return self.render_timed(stem, ratio, layout, background)[:3]

    def render_timed(
        self,
        stem: str,
        ratio: str,
        layout: Optional[Dict] = None,
        background: str = "solid",
    ):
        """render() plus a per-request phase split (timings_ms dict with
        solve/queue/device/readback, merged count). Samples feed the
        /v1/stats rolling percentiles."""
        self._check_open()
        t0 = time.perf_counter()
        placements, canvas_size = self.solve(stem, ratio, layout)
        solve_ms = round((time.perf_counter() - t0) * 1e3, 2)
        composed, timings = self._coalescer(
            stem, canvas_size, background
        ).render_timed(placements)
        timings = dict(timings, solve_ms=solve_ms)
        self.record_latency(
            solve=solve_ms,
            queue=timings.get("queue_ms"),
            pipeline_wait=timings.get("pipeline_wait_ms"),
            dispatch=timings.get("dispatch_ms"),
            device=timings.get("device_ms"),
            device_residual=timings.get("device_residual_ms"),
            readback=timings.get("readback_ms"),
        )
        return placements, canvas_size, composed, timings

    def record_latency(self, **phases) -> None:
        """Append phase samples (ms; None skipped) to the rolling stats."""
        with self._latency_lock:
            for phase, ms in phases.items():
                if ms is not None and phase in self._latency:
                    self._latency[phase].append(float(ms))

    def _get_device_inputs(self, stem: str, bundle, prog):
        """Object tensors on the device, shared by every batch step of this
        (bundle, layout object order) — cached separately from the steps
        so evicted step entries don't strand large device buffers."""
        input_key = (stem, tuple(int(oid) for oid in prog.obj_ids))
        with self._lock:
            inputs = self._device_inputs.get(input_key)
        if inputs is not None:
            return inputs
        with self._key_lock("inputs", input_key):
            with self._lock:
                inputs = self._device_inputs.get(input_key)
            if inputs is None:
                from ..pipeline.fused import map_bundle_to_program

                inputs = tuple(
                    torch.from_numpy(a).to(self.device)
                    for a in map_bundle_to_program(prog, bundle, bundle.to_arrays())
                )
                with self._lock:
                    if len(self._device_inputs) >= self.MAX_DEVICE_INPUTS:
                        self._device_inputs.pop(next(iter(self._device_inputs)))
                    inputs = self._device_inputs.setdefault(input_key, inputs)
            return inputs

    def _build_batch_step(self, stem: str, bundle, prog, canon_ratios,
                          background: str):
        """The fused K2 step for one canonical ratio set. Returns
        (step, sizes_dev, bg_dev, canon_sizes).

        JAX's service probes the Pallas step here and latches its XLA
        compose when that fails; the port builds the K2 step only. A K2
        failure raises from the request that runs the step, and the next
        request tries K2 again."""
        from ..layout.canvas import compute_canvas_size
        from ..pipeline.fused import background_spec, make_fused_render

        canon_sizes = [
            compute_canvas_size(bundle.background.size, r, verbose=False)
            for r in canon_ratios
        ]
        w_max = max(w for w, _ in canon_sizes)
        h_max = max(h for _, h in canon_sizes)
        # pad envelope from metadata (as to_arrays' default), without
        # building the padded object tensor a second time
        obj_pad = (
            max((m.height for m in bundle.meta.values()), default=1),
            max((m.width for m in bundle.meta.values()), default=1),
        )
        bg_dev, horizontal = background_spec(self._background(bundle), background)
        sizes_dev = torch.tensor(canon_sizes, dtype=torch.int32, device=self.device)
        # exact per-object (h, w) asset sizes (sizes() returns (w, h);
        # unknown object ids keep (0, 0))
        size_map = bundle.sizes()
        static_hw = tuple(
            (int(size_map[int(oid)][1]), int(size_map[int(oid)][0]))
            if int(oid) in size_map else (0, 0)
            for oid in prog.obj_ids
        )
        step = make_fused_render(
            prog, (h_max, w_max), obj_pad, kernel="pallas",
            background=background, gradient_horizontal=horizontal,
            static_obj_hw=static_hw,
        )
        return step, sizes_dev, bg_dev, canon_sizes

    def render_batch(
        self,
        stem: str,
        ratios,
        layout: Optional[Dict] = None,
        background: str = "solid",
    ):
        """All ratio variants in ONE device pass (throughput path).

        The fused solve + background + K2 step, cached per (bundle, layout
        structure, canonical ratio set, background) — the ratio set is
        sorted and deduped, so request order never rebuilds — and built
        once per key. Request validation happens before any kernel work,
        so user errors (bad ratio/layout) raise first.
        Returns {ratio: (canvas_size, boxes list, np.uint8 [H, W, 4])}.
        Numerics: traced-table envelope (<= 2/255 vs PIL), vs the
        bit-exact per-request /v1/render path.
        """
        return dict(self.render_batch_iter(
            stem, ratios, layout=layout, background=background,
        ))

    def render_batch_iter(
        self,
        stem: str,
        ratios,
        layout: Optional[Dict] = None,
        background: str = "solid",
    ):
        """:meth:`render_batch` as an iterator of ``(ratio, entry)``.

        One fused device pass, then each requested ratio's EXACT canvas is
        read back as a device-side crop of the padded
        ``[n, h_max, w_max, 4]`` stack, every crop's host copy started up
        front, so a consumer that PNG-encodes ratio i overlaps the copy of
        ratio i+1.

        Validation, dispatch and the boxes' readback (which waits for the
        pass) run eagerly in THIS call (bad input and device failures
        raise here, not mid-iteration); only the crops' host copies are
        waited on lazily.
        """
        result, ratios, canon, canon_sizes = self._render_batch_dispatch(
            stem, ratios, layout, background
        )
        index = {r: i for i, r in enumerate(canon)}
        # boxes first: a tiny read that waits for the pass, so device-side
        # failures surface here (before any stream line goes out)
        boxes_np = result[1].cpu().numpy()
        crops = {}
        for r in dict.fromkeys(ratios):
            i = index[r]
            w, h = canon_sizes[i]
            crops[r] = _HostCopy(result[0][i, :h, :w])

        def _entries():
            # one line per unique ratio, as the buffered dict folds them
            for r in dict.fromkeys(ratios):
                i = index[r]
                w, h = canon_sizes[i]
                yield r, ((w, h), boxes_np[i].tolist(), crops[r].numpy())

        return _entries()

    def _render_batch_dispatch(self, stem, ratios, layout, background):
        """Validate the request, fetch/build the cached fused step, and
        dispatch ONE device pass. Returns ``(device result, ratios list,
        canon ratio order, canon_sizes)`` with the result still on device.
        """
        from ..layout.canvas import compute_canvas_size
        from ..layout.solve import FlexProgram

        self._check_open()
        if background not in ("solid", "gradient"):
            raise ValueError(f"unknown background mode: {background!r}")
        bundle = self._bundle(stem)
        layout = self._resolve_layout(bundle, layout)
        ratios = list(ratios)
        # ---- user-input validation: raises BEFORE any kernel work ----
        for r in ratios:
            compute_canvas_size(bundle.background.size, r, verbose=False)
        prog = FlexProgram.from_dsl(layout["root"])

        canon = sorted(set(ratios))
        key = (
            stem, json.dumps(layout["root"], sort_keys=True),
            tuple(canon), background,
        )
        with self._lock:
            entry = self._batch_steps.get(key)
        if entry is None:
            with self._key_lock("batch", key):
                with self._lock:
                    entry = self._batch_steps.get(key)
                if entry is None:
                    entry = self._build_batch_step(
                        stem, bundle, prog, canon, background
                    )
                    with self._lock:
                        if len(self._batch_steps) >= self.MAX_BATCH_STEPS:
                            self._batch_steps.pop(next(iter(self._batch_steps)))
                        entry = self._batch_steps.setdefault(key, entry)
                    self._remember_step(stem, layout, canon, background)
        step, sizes_dev, bg_dev, canon_sizes = entry
        inputs = self._get_device_inputs(stem, bundle, prog)
        result = step(sizes_dev, bg_dev, *inputs)
        return result, ratios, canon, canon_sizes

    def render_fleet(
        self,
        stems: Optional[Sequence[str]] = None,
        ratios: Sequence[str] = ("1:1",),
        layout: Optional[Dict] = None,
        background: str = "solid",
        parallel: int = 4,
    ) -> Dict[str, Dict]:
        """The fleet matrix: every requested bundle at every ratio.

        Per bundle one fused device pass via :meth:`render_batch` (so steps
        and device inputs come from the same caches), bundles overlapped
        across a small thread pool.

        Per-bundle failures are isolated: a missing bundle or bad layout
        yields ``{"error": str}`` for that stem and never poisons the rest.
        Returns ``{stem: {"renders": render_batch result} | {"error": …}}``
        in the requested stem order.
        """
        stems = self._resolve_stems(stems)
        results = dict(self.render_fleet_iter(
            stems, ratios, layout=layout, background=background,
            parallel=parallel,
        ))
        return {stem: results[stem] for stem in stems}

    def _resolve_stems(self, stems: Optional[Sequence[str]]):
        if stems is None:
            stems = [b["stem"] for b in self.list_bundles()]
        return list(stems)

    def render_fleet_iter(
        self,
        stems: Optional[Sequence[str]] = None,
        ratios: Sequence[str] = ("1:1",),
        layout: Optional[Dict] = None,
        background: str = "solid",
        parallel: int = 4,
    ):
        """Yield ``(stem, entry)`` fleet results in COMPLETION order: the
        streaming counterpart of :meth:`render_fleet` (same thread pool,
        caches, and per-bundle error isolation).

        The pool stays the service's until its threads are joined: a
        generator dropped mid-iteration leaves its running bundles to
        finish, and :meth:`close` joins them."""
        from concurrent.futures import ThreadPoolExecutor, as_completed

        self._check_open()
        stems = self._resolve_stems(stems)
        ratios = list(ratios)

        def one(stem: str):
            try:
                return stem, {"renders": self.render_batch(
                    stem, ratios, layout=layout, background=background,
                )}
            except Exception as e:  # noqa: BLE001 - per-bundle isolation
                return stem, {"error": str(e)}

        pool = ThreadPoolExecutor(max_workers=max(1, parallel),
                                  thread_name_prefix="render-fleet")
        futures = [pool.submit(one, stem) for stem in stems]
        entry = (pool, futures)
        with self._lock:
            self._fleet_pools.append(entry)
        try:
            for fut in as_completed(futures):
                yield fut.result()
        finally:
            # abandoned mid-iteration (a streaming client disconnected):
            # drop queued bundles instead of rendering them for nobody
            pool.shutdown(wait=False, cancel_futures=True)
            if all(f.done() for f in futures):
                pool.shutdown(wait=True)  # nothing runs: its threads exit now
                with self._lock:
                    if entry in self._fleet_pools:
                        self._fleet_pools.remove(entry)

    def stats(self) -> Dict[str, int]:
        """Cache and coalescing counters for observability endpoints (the
        JAX package's keys; ``batch_latched`` is always False, as the port
        latches no fallback)."""
        with self._lock:
            counters = {
                "bundles_loaded": len(self._bundles),
                "engines": len(self._engines),
                "batch_steps": len(self._batch_steps),
                "device_inputs": len(self._device_inputs),
                "batch_latched": False,
            }
        counters.update(self.coalescing_stats())
        counters["latency_ms"] = self.latency_stats()
        counters["dispatch_floor"] = self.floor.info()
        with self._lock:
            cos = list(self._coalescers.items())
        calibs = {
            "/".join(str(p) for p in key): co.calibration_info()
            for key, co in cos
        }
        counters["device_calibration"] = {k: v for k, v in calibs.items() if v}
        counters["backlog_age_s"] = round(self.backlog_age_s(), 1)
        return counters

    def latency_stats(self) -> Dict[str, Dict[str, float]]:
        """p50/p95/count per single-render phase from the rolling samples
        (an empty phase reports count 0)."""
        out: Dict[str, Dict[str, float]] = {}
        with self._latency_lock:
            snap = {k: list(v) for k, v in self._latency.items()}
        for phase, samples in snap.items():
            if not samples:
                out[phase] = {"count": 0}
                continue
            s = sorted(samples)
            out[phase] = {
                "count": len(s),
                "p50_ms": round(s[len(s) // 2], 2),
                "p95_ms": round(s[min(len(s) - 1, int(len(s) * 0.95))], 2),
            }
        return out

    # ------------------- warm-start manifest (restarts) -------------------

    def _remember_step(self, stem: str, layout: Dict, canon_ratios,
                       background: str) -> None:
        """Record a built batch-step key so a restarted daemon can rebuild
        it before traffic."""
        record = {
            "stem": stem,
            "layout": layout,
            "ratios": list(canon_ratios),
            "background": background,
        }
        try:
            with self._key_lock("manifest", "manifest"):
                records = self._load_manifest()
                if record not in records:
                    records.append(record)
                    records = records[-self.MANIFEST_RECORDS:]
                    self.manifest_path.parent.mkdir(parents=True, exist_ok=True)
                    tmp = self.manifest_path.with_suffix(".tmp")
                    tmp.write_text(json.dumps(records), encoding="utf-8")
                    tmp.replace(self.manifest_path)
        except OSError:
            pass  # the manifest is an optimization; never fail a request on it

    def _load_manifest(self) -> List[Dict]:
        try:
            records = json.loads(self.manifest_path.read_text(encoding="utf-8"))
            return records if isinstance(records, list) else []
        except (OSError, ValueError):
            return []

    def warm_start(self) -> int:
        """Rebuild every manifest-recorded batch step whose bundle still
        exists (stopping at close()). Returns the number of steps warmed."""
        warmed = 0
        for record in self._load_manifest():
            if self._closed:
                break
            stem = record.get("stem", "")
            if not (self.root / stem / "results.json").exists():
                continue
            try:
                self.render_batch(
                    stem, record.get("ratios") or ["1:1"],
                    layout=record.get("layout"),
                    background=record.get("background", "solid"),
                )
                warmed += 1
            except Exception as e:  # noqa: BLE001 - warmup must not crash
                print(f"[serving] warm-start skipped {record}: {e!r}",
                      file=sys.stderr)
        return warmed

    def warm_start_in_background(self) -> threading.Thread:
        """:meth:`warm_start` on a thread that :meth:`close` joins; it
        prints the number of steps warmed."""
        def run():
            warmed = self.warm_start()
            if warmed:
                print(f"[serving] warm-started {warmed} batch step(s)")

        thread = threading.Thread(target=run, daemon=True, name="warm-start")
        with self._lock:
            self._check_open()
            self._warm_threads.append(thread)
        thread.start()
        return thread


def make_handler(service: ComposeService):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 is required for Transfer-Encoding: chunked (the
        # streaming endpoints); every non-chunked response sets an exact
        # Content-Length, so keep-alive stays framed correctly.
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass

        def _send(
            self, code, content: bytes, ctype: str, extra_headers=None
        ) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(content)))
            for name, value in (extra_headers or {}).items():
                self.send_header(name, value)
            if self.close_connection:
                # e.g. unparsable request framing (_read_body): tell the
                # client explicitly rather than just dropping the socket
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(content)

        def _read_body(self) -> bytes:
            """Read the request body, ALWAYS, for keep-alive framing: an
            unread body's bytes would be parsed as the next request line.
            An unparsable Content-Length means the framing is unknowable,
            so the connection is marked for close before the error."""
            try:
                length = int(self.headers.get("Content-Length", "0") or 0)
            except ValueError:
                self.close_connection = True
                raise
            return self.rfile.read(max(0, length))

        # ------------- chunked NDJSON streaming (opt-in) -------------

        def _can_stream(self) -> bool:
            """Chunked transfer needs an HTTP/1.1 client; a 1.0 client
            asking for "stream" degrades to the buffered response."""
            return self.request_version >= "HTTP/1.1"

        def _start_chunked(self, ctype: str = "application/x-ndjson") -> None:
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

        def _write_chunk(self, data: bytes) -> None:
            self.wfile.write(f"{len(data):X}\r\n".encode("ascii"))
            self.wfile.write(data)
            self.wfile.write(b"\r\n")

        def _stream_lines(self, lines) -> None:
            """Send an iterable of JSON-able objects as chunked NDJSON, one
            line flushed per object. A producer failure mid-stream becomes
            a final {"error": ...} line (the 200 status already went out).
            Never raises: a socket write failure (client gone) marks the
            connection for close, abandoning the producer."""
            try:
                self._start_chunked()
                try:
                    for obj in lines:
                        self._write_chunk(
                            json.dumps(obj).encode("utf-8") + b"\n"
                        )
                except Exception as e:  # noqa: BLE001 - producer failed
                    self._write_chunk(
                        json.dumps({"error": str(e)}).encode("utf-8") + b"\n"
                    )
                self.wfile.write(b"0\r\n\r\n")
            except Exception:  # noqa: BLE001 - write failed mid-body
                self.close_connection = True

        def _json(self, obj, code=200):
            self._send(code, json.dumps(obj).encode("utf-8"), "application/json")

        def do_GET(self):  # noqa: N802
            try:
                self._read_body()  # a GET may legally carry a body; drain it
                if self.path == "/healthz":
                    # a backlog older than the render deadline means the
                    # drain worker is stuck on a wedged device call:
                    # report unhealthy so a balancer fails over
                    backlog = service.backlog_age_s()
                    return self._json({
                        "ok": backlog <= _RENDER_WAIT_S,
                        "device": service.device_name(),
                        "bundles": len(service.list_bundles()),
                        "backlog_age_s": round(backlog, 1),
                    })
                if self.path == "/v1/bundles":
                    return self._json(service.list_bundles())
                if self.path == "/v1/stats":
                    return self._json(service.stats())
                return self._json({"error": "not found"}, 404)
            except (BrokenPipeError, ConnectionResetError):
                # the client vanished mid-reply: drop the connection quietly
                self.close_connection = True
            except Exception as e:  # noqa: BLE001
                return self._error_reply(str(e), 500)

        def do_POST(self):  # noqa: N802
            try:
                if self.path == "/v1/render_batch":
                    return self._render_batch()
                if self.path == "/v1/render_fleet":
                    return self._render_fleet()
                if self.path != "/v1/render":
                    self._read_body()  # drain: keep-alive framing
                    return self._json({"error": "not found"}, 404)
                req = json.loads(self._read_body() or b"{}")
                stem = req["bundle"]
                ratio = req.get("ratio", "1:1")
                if req.get("boxes_only"):
                    # no device work and no readback for a placements query
                    placements, canvas_size = service.solve(
                        stem, ratio, layout=req.get("layout")
                    )
                    return self._json({
                        "canvas": {"width": canvas_size[0], "height": canvas_size[1]},
                        "placements": placements,
                    })
                placements, canvas_size, composed, timings = (
                    service.render_timed(
                        stem, ratio,
                        layout=req.get("layout"),
                        background=req.get("background", "solid"),
                    )
                )
                if req.get("format") == "raw":
                    # raw RGBA for LAN/colocated clients: no PNG encode;
                    # shape and dtype ride headers
                    timings.pop("_png_share", None)
                    h, w, c = composed.shape
                    return self._send(
                        200, composed.tobytes(), "application/octet-stream",
                        extra_headers={
                            "X-Raw-Shape": f"{h},{w},{c}",
                            "X-Raw-Dtype": "uint8",
                            "X-Render-Timings": json.dumps(timings),
                        },
                    )
                # native zlib-level-1 encoder, PIL fallback. Deduped
                # requests share ONE encode: the first handler in encodes
                # under the share's lock, the rest reuse the bytes.
                from ..core.native_io import png_bytes

                share = timings.pop("_png_share", None)
                t_enc = time.perf_counter()
                if share is None:
                    png = png_bytes(composed)
                else:
                    with share["lock"]:
                        png = share.get("png")
                        if png is None:
                            png = share["png"] = png_bytes(composed)
                timings["encode_ms"] = round(
                    (time.perf_counter() - t_enc) * 1e3, 2
                )
                service.record_latency(encode=timings["encode_ms"])
                # the phase split rides a header so the PNG body stays pure
                return self._send(
                    200, png, "image/png",
                    extra_headers={"X-Render-Timings": json.dumps(timings)},
                )
            except (BrokenPipeError, ConnectionResetError):
                self.close_connection = True  # client vanished mid-reply
            except KeyError as e:
                return self._error_reply(f"missing field {e}", 400)
            except FileNotFoundError as e:
                return self._error_reply(str(e), 404)
            except RenderStuckError as e:
                # wedged device pipeline: a retryable service condition,
                # not a caller error — 503 so clients/balancers back off
                return self._error_reply(str(e), 503)
            except Exception as e:  # noqa: BLE001
                return self._error_reply(str(e), 500)

        def _error_reply(self, message: str, code: int):
            """JSON error reply that tolerates an already-dead client."""
            try:
                return self._json({"error": message}, code)
            except (BrokenPipeError, ConnectionResetError):
                self.close_connection = True

        def _render_batch(self):
            """POST /v1/render_batch: all ratio variants in one device pass.

            {"bundle": "<stem>", "ratios": ["9:16", ...],
             "layout": {"root": {...}}?,
             "background": "solid"|"gradient"?}  ->
            {"<ratio>": {"canvas": {...}, "boxes": [...], "png_b64": "..."}}

            With "stream": true the response is chunked NDJSON instead —
            one {"ratio": ..., canvas, boxes, png_b64} line per requested
            ratio, each flushed as soon as it is encoded.
            """
            try:
                req = json.loads(self._read_body() or b"{}")
                stem = req["bundle"]
                ratios = req.get("ratios") or ["1:1"]
                kwargs = dict(
                    layout=req.get("layout"),
                    background=req.get("background", "solid"),
                )
                if req.get("stream") and self._can_stream():
                    # raises on bad input / device failure BEFORE any line
                    # is streamed (dispatch and fence are eager)
                    entries = service.render_batch_iter(
                        stem, ratios, **kwargs
                    )
                    return self._stream_lines(
                        {"ratio": r, **_encode_render_entry(entry)}
                        for r, entry in entries
                    )
                return self._json(
                    _encode_renders(service.render_batch(stem, ratios,
                                                         **kwargs))
                )
            except KeyError as e:
                return self._json({"error": f"missing field {e}"}, 400)
            except FileNotFoundError as e:
                return self._json({"error": str(e)}, 404)
            except Exception as e:  # noqa: BLE001
                return self._json({"error": str(e)}, 500)

        def _render_fleet(self):
            """POST /v1/render_fleet: the bundles x ratios matrix.

            {"bundles": ["<stem>", ...]?, "ratios": ["9:16", ...]?,
             "layout": {"root": {...}}?, "background": ...?}  ->
            {"<stem>": {"<ratio>": {canvas, boxes, png_b64}} |
                       {"error": "..."}}

            With "stream": true the response is chunked NDJSON — one
            {"bundle": ..., "renders": {...}} (or {"bundle": ...,
            "error": ...}) line per bundle in COMPLETION order.
            """
            try:
                req = json.loads(self._read_body() or b"{}")
                kwargs = dict(
                    stems=req.get("bundles"),
                    ratios=req.get("ratios") or ["1:1"],
                    layout=req.get("layout"),
                    background=req.get("background", "solid"),
                )
                if req.get("stream") and self._can_stream():
                    def lines():
                        for stem, entry in service.render_fleet_iter(**kwargs):
                            if "error" in entry:
                                yield {"bundle": stem, "error": entry["error"]}
                            else:
                                yield {
                                    "bundle": stem,
                                    "renders": _encode_renders(entry["renders"]),
                                }

                    return self._stream_lines(lines())
                results = service.render_fleet(**kwargs)
                payload = {}
                for stem, entry in results.items():
                    if "error" in entry:
                        payload[stem] = {"error": entry["error"]}
                    else:
                        payload[stem] = _encode_renders(entry["renders"])
                return self._json(payload)
            except Exception as e:  # noqa: BLE001
                return self._json({"error": str(e)}, 500)

    return Handler


def _encode_render_entry(entry) -> Dict:
    """One render entry (canvas_size, boxes, img) -> its JSON payload."""
    import base64

    from ..core.native_io import png_bytes

    canvas_size, boxes, img = entry
    return {
        "canvas": {"width": canvas_size[0], "height": canvas_size[1]},
        "boxes": boxes,
        "png_b64": base64.b64encode(png_bytes(img)).decode(),
    }


def _encode_renders(results: Dict) -> Dict:
    """render_batch result -> JSON payload (boxes + base64 native PNG)."""
    return {r: _encode_render_entry(entry) for r, entry in results.items()}


class _Server(ThreadingHTTPServer):
    """The daemon's HTTP server; ``server_close()`` also closes the
    service when ``owns_service`` (serve() built it)."""

    owns_service = False

    def server_close(self) -> None:
        super().server_close()
        if self.owns_service:
            self.service.close()


def serve(bundles_root, host: str = "127.0.0.1", port: int = 8601,
          service: Optional[ComposeService] = None, device="cuda"):
    """Build the HTTP daemon on ``device`` (default "cuda"; raises without
    a card); the caller runs ``serve_forever``. A given ``service`` brings
    its own device and stays the caller's to close; one built here is
    closed by the server's ``server_close()``."""
    owned = service is None
    service = service or ComposeService(bundles_root, device=device)
    server = _Server((host, port), make_handler(service))
    server.service = service
    server.owns_service = owned
    return server


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Compose serving daemon (PyTorch/CUDA)")
    parser.add_argument("--bundles-root", default="data")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8601)
    parser.add_argument(
        "--device", default="cuda",
        help="cuda (default; raises without a card) or cpu (plain versions)",
    )
    parser.add_argument(
        "--no-warm-start", action="store_true",
        help="skip rebuilding manifest-recorded batch steps at startup",
    )
    args = parser.parse_args(argv)

    server = serve(args.bundles_root, args.host, args.port, device=args.device)
    if not args.no_warm_start:
        # rebuild previously served batch steps in the background so the
        # first real request after a restart finds them built
        server.service.warm_start_in_background()
    print(f"serving bundles from {args.bundles_root} on http://{args.host}:{args.port} "
          f"({server.service.device_name()})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        # closes the service serve() built: joins the warm start and the
        # drain workers
        server.server_close()


if __name__ == "__main__":
    main()
