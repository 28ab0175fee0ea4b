"""Asynchronous SLAM runtime: the local-mapping thread.

Port of the mapper half of ``orbslam3_tpu/models/async_runtime.py`` (the
reference's thread architecture): tracking runs in the caller's thread and
never blocks on BA; it hands new keyframes to the mapper through a small
queue with the reference's back-pressure rules (the queue<3 gate and the
stop request). The mapper thread pops keyframes and runs the mapping round
(triangulation, fuse, local BA, culling). The loop-closing thread and the
background global BA are not ported yet (ROADMAP.md, Queue 1 item 3);
``request_stop``/``release`` are the pause they will use.

Cross-thread map consistency is the per-map ``MapState.lock``: tracking holds
it through the Track() core, the mapper while it gathers and writes back.
Device compute runs outside the lock on gathered snapshots.

Two host threads, one device. On a CUDA device the mapper thread always
enqueues on a stream of its own: the tracker's read-back event then sits
behind the tracker's work only, never behind a bundle adjustment the mapper
has queued. (While the frame is bound by the host's launch rate the device
queue is short and the stream changes no measured time, PERF.md section 6; it
is what keeps tracking independent of mapping once the launches get fewer.)
The two streams share no buffer: the device mirrors of the map are per stream
(``models/device_map.py``), every other tensor is made and used by one
thread, and the host map is the only hand-off.

Abort protocol: while newer keyframes wait, or a stop is requested, a mapper
round skips local BA and keyframe culling (``abort_requested``).
"""
from __future__ import annotations

import threading
import time
import traceback
from collections import deque

import torch


class _KFQueue:
    """Keyframe queue with map tagging (stale entries from a replaced map are
    dropped by the consumer)."""

    def __init__(self):
        self._q: deque = deque()
        self._cv = threading.Condition()

    def push(self, item):
        with self._cv:
            self._q.append(item)
            self._cv.notify()

    def pop(self, timeout: float = 0.05, on_take=None):
        """Next item or None after ``timeout``; ``on_take`` runs under the
        queue's lock, before anyone can see the queue without the item."""
        with self._cv:
            if not self._q:
                self._cv.wait(timeout)
            if self._q:
                if on_take is not None:
                    on_take()
                return self._q.popleft()
            return None

    def empty_and(self, flag: threading.Event) -> bool:
        """Queue empty and ``flag`` set, read under the queue's lock."""
        with self._cv:
            return not self._q and flag.is_set()

    def __len__(self):
        return len(self._q)


class AsyncRuntime:
    """Owns the mapper thread of a SlamSystem."""

    def __init__(self, system):
        self.system = system
        self.kf_queue = _KFQueue()       # tracking → mapper
        self._finish = threading.Event()
        self._stop_requested = threading.Event()   # pause the mapper
        self._stopped = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        device = system.device
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._mapper_thread = threading.Thread(
            target=self._mapper_run, name="local-mapping", daemon=True)
        self._mapper_thread.start()

    # -- tracking-side API ------------------------------------------------
    def insert_keyframe(self, kf_id: int, initial: bool):
        self.kf_queue.push((self.system.map, kf_id, initial))

    def accepting(self) -> bool:
        """Back-pressure for the keyframe policy (the reference's queue<3
        gate, and no keyframes while a stop is requested)."""
        return len(self.kf_queue) < 3 and not self._stop_requested.is_set()

    def on_map_remap(self, m, kf_remap):
        """Map pools compacted (mapper thread, under the map lock): rewrite
        queued keyframe ids for that map; drop culled ones."""
        q = self.kf_queue
        with q._cv:
            items = list(q._q)
            q._q.clear()
            for item in items:
                if item[0] is m:
                    nid = int(kf_remap[item[1]])
                    if nid < 0:
                        continue
                    item = (m, nid) + tuple(item[2:])
                q._q.append(item)

    def abort_requested(self) -> bool:
        """Local BA is skipped when newer keyframes are waiting (the
        reference's mbAbortBA) or a stop was requested."""
        return len(self.kf_queue) > 0 or self._stop_requested.is_set()

    # -- mapper pause (the reference's RequestStop / Release) --------------
    def request_stop(self, timeout: float = 30.0):
        self._stop_requested.set()
        t0 = time.monotonic()
        while not (self._stopped.is_set() or self._idle.is_set()):
            if time.monotonic() - t0 > timeout:
                break
            time.sleep(0.002)

    def release(self):
        self._stop_requested.clear()

    # -- lifecycle ---------------------------------------------------------
    def wait_idle(self, timeout: float = 120.0) -> bool:
        """Wait until the queue is drained and the mapper is idle."""
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            if self.kf_queue.empty_and(self._idle):
                return True
            time.sleep(0.005)
        return False

    def shutdown(self, timeout: float = 120.0):
        self.wait_idle(timeout)
        self._finish.set()
        self._mapper_thread.join(timeout)

    # -- the thread ----------------------------------------------------------
    def _mapper_run(self):
        with torch.cuda.stream(self._stream):        # no stream (the CPU): a no-op
            while not self._finish.is_set():
                if self._stop_requested.is_set():
                    self._stopped.set()
                    time.sleep(0.003)
                    continue
                self._stopped.clear()
                # busy from the moment the item leaves the queue: wait_idle
                # never sees an empty queue and a stale idle flag together
                item = self.kf_queue.pop(timeout=0.05, on_take=self._idle.clear)
                if item is None:
                    if len(self.kf_queue) == 0:
                        self._idle.set()
                    continue
                m, kf_id, initial = item
                sysm = self.system
                if m is sysm.map:           # else: stale entry of a replaced map
                    try:
                        sysm.mapper.process_keyframe(
                            kf_id, initial=initial, abort_check=self.abort_requested)
                    except Exception as e:  # the pipeline outlives a failed round
                        stats = sysm.mapper.stats
                        stats["mapper_errors"] = stats.get("mapper_errors", 0) + 1
                        stats["last_mapper_error"] = (
                            f"{e!r}\n{traceback.format_exc(limit=6)}")
                if len(self.kf_queue) == 0:
                    self._idle.set()
