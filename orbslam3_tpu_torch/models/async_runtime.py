"""Asynchronous SLAM runtime: the mapper and loop-closing threads, and the
background global BA.

Port of ``orbslam3_tpu/models/async_runtime.py`` (the reference's thread
architecture):

- Tracking runs in the caller's thread and never blocks on BA; it hands new
  keyframes to the mapper through a small queue with the reference's
  back-pressure rules (the queue<3 gate and the stop request).
- The mapper thread pops keyframes, runs the mapping round (triangulation,
  fuse, local BA, culling) and pushes each processed keyframe, under its
  possibly remapped id, to the loop-closing thread.
- The loop-closing thread runs place recognition, verification, correction
  and merge detection (``LoopCloser.process_keyframe``). A correction pauses
  the mapper (``request_stop`` / ``release``) and kills a running global BA
  first; after it a ``BackgroundGBA`` thread runs the global BA with the
  reference's abort checks and propagates its result to keyframes made
  meanwhile.

Cross-thread map consistency is the per-map ``MapState.lock``: tracking holds
it through the Track() core, the mapper while it gathers and writes back,
the loop closer during verification and correction. Device compute runs
outside the lock on gathered snapshots.

Host threads, one device. On a CUDA device each of the mapper, loop-closing
and global-BA threads enqueues on a stream of its own: the tracker's
read-back event then sits behind the tracker's work only. The streams share
no buffer: the device mirrors of the map are per stream
(``models/device_map.py``), every other tensor is made and used by one
thread (constants, such as the vocabulary's, are settled on upload), and the
host map is the only hand-off.

An exception in a thread's round is counted and kept, never hidden, and the
thread goes on: ``mapper_errors`` and ``gba_errors`` in the mapper's stats,
``lc_errors`` in the loop closer's (``SlamSystem.stats()`` carries all).
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


def _error(stats: dict, key: str, e: Exception):
    stats[f"{key}s"] = stats.get(f"{key}s", 0) + 1
    stats[f"last_{key}"] = f"{e!r}\n{traceback.format_exc(limit=6)}"


class AsyncRuntime:
    """Owns the mapper and loop-closing threads of a SlamSystem and its
    background global BA."""

    def __init__(self, system):
        self.system = system
        self.kf_queue = _KFQueue()       # tracking → mapper
        self.loop_queue = _KFQueue()     # mapper → loop closing
        self._finish = threading.Event()
        self._stop_requested = threading.Event()   # pause the mapper
        self._stopped = threading.Event()
        self._idle = threading.Event()             # the mapper
        self._idle.set()
        self._loop_idle = threading.Event()
        self._loop_idle.set()
        self.gba: BackgroundGBA | None = None
        device = system.device
        self._cuda = device if device.type == "cuda" else None
        self._stream = torch.cuda.Stream(device) if self._cuda else None
        self._loop_stream = torch.cuda.Stream(device) if self._cuda else None
        self._mapper_thread = threading.Thread(
            target=self._mapper_run, name="local-mapping", daemon=True)
        self._loop_thread = threading.Thread(
            target=self._loop_run, name="loop-closing", daemon=True)
        self._mapper_thread.start()
        self._loop_thread.start()

    # -- tracking-side API ------------------------------------------------
    def insert_keyframe(self, kf_id: int, initial: bool):
        self.kf_queue.push((self.system.map, kf_id, initial))

    def accepting(self) -> bool:
        """Back-pressure for the keyframe policy (the reference's queue<3
        gate, and no keyframes while a stop is requested)."""
        return len(self.kf_queue) < 3 and not self._stop_requested.is_set()

    def on_map_remap(self, m, kf_remap):
        """Map pools compacted (mapper thread, under the map lock): rewrite
        queued keyframe ids for that map in both queues; drop culled ones."""
        for q in (self.kf_queue, self.loop_queue):
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
    def _gba_running(self) -> bool:
        g = self.gba
        return g is not None and g.running

    def wait_idle(self, timeout: float = 120.0) -> bool:
        """Wait until both queues are drained, both threads idle and no global
        BA runs. Each stage hands its work on before it marks itself idle, so
        checking them in pipeline order cannot miss work in flight."""
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            if (self.kf_queue.empty_and(self._idle)
                    and self.loop_queue.empty_and(self._loop_idle)
                    and not self._gba_running()):
                return True
            time.sleep(0.005)
        return False

    def shutdown(self, timeout: float = 120.0):
        """Drain, then join the global-BA, mapper and loop-closing threads."""
        self.wait_idle(timeout)
        if self.gba is not None:
            self.gba.abort()
            self.gba.join(timeout)
        self._finish.set()
        self._mapper_thread.join(timeout)
        self._loop_thread.join(timeout)

    def threads_alive(self) -> list[str]:
        """Names of this runtime's threads still running."""
        ths = [self._mapper_thread, self._loop_thread]
        if self.gba is not None:
            ths.append(self.gba._thread)
        return [t.name for t in ths if t.is_alive()]

    # -- threads -------------------------------------------------------------
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
                        kf_id = sysm.mapper.process_keyframe(
                            kf_id, initial=initial, abort_check=self.abort_requested)
                        if not initial:
                            self.loop_queue.push((m, kf_id))
                    except Exception as e:  # the pipeline outlives a failed round
                        _error(sysm.mapper.stats, "mapper_error", e)
                if len(self.kf_queue) == 0:
                    self._idle.set()

    def _loop_run(self):
        with torch.cuda.stream(self._loop_stream):
            while not self._finish.is_set():
                item = self.loop_queue.pop(timeout=0.05, on_take=self._loop_idle.clear)
                if item is None:
                    self._loop_idle.set()
                    continue
                m, kf_id = item
                sysm = self.system
                lc = getattr(sysm, "loop_closer", None)
                try:
                    if m is sysm.map and lc is not None:
                        if lc.process_keyframe(kf_id, pre_correct=self._pre_correct,
                                               post_correct=self.release):
                            self._start_gba()
                except Exception as e:
                    _error(lc.stats, "lc_error", e)
                finally:
                    # an exception between pre_correct and post_correct must
                    # not leave the mapper paused (release() is idempotent)
                    self.release()
                    if len(self.loop_queue) == 0:
                        self._loop_idle.set()

    def _pre_correct(self):
        """Before a loop correction: kill a running global BA and pause the
        mapper (the reference's CorrectLoop step 1)."""
        if self.gba is not None:
            self.gba.abort()
            self.gba.join()
            self.gba = None
        self.request_stop()

    def _start_gba(self):
        if self.gba is not None and self.gba.running:
            self.gba.abort()
            self.gba.join()
        self.gba = BackgroundGBA(self.system, stream=(
            torch.cuda.Stream(self._cuda) if self._cuda else None))
        self.gba.start()


class BackgroundGBA:
    """Abortable global BA concurrent with tracking and mapping (the
    reference's transient GBA thread), with the propagation of its result to
    keyframes and points created during the run. An aborted run writes
    nothing back."""

    def __init__(self, system, iters: int = 10, stream=None):
        self.system = system
        self.map = system.map
        self.iters = iters
        self._stream = stream
        self._abort = threading.Event()
        self.running = False
        self.applied = None              # True / False once the run ended
        self._thread = threading.Thread(target=self._run, name="global-ba", daemon=True)

    def start(self):
        self.running = True
        self._thread.start()

    def abort(self):
        self._abort.set()

    def join(self, timeout: float = 300.0):
        self._thread.join(timeout)

    def _run(self):
        mapper = self.system.mapper
        try:
            with torch.cuda.stream(self._stream):
                if getattr(self.system.tracker, "imu_initialized", False):
                    self.applied = self._run_inertial(mapper)
                else:
                    self.applied = mapper.global_ba(iters=(4, self.iters),
                                                    abort_check=self._abort.is_set,
                                                    propagate=True)
        except Exception as e:
            self.applied = False
            _error(mapper.stats, "gba_error", e)
        finally:
            self.running = False

    def _run_inertial(self, mapper) -> bool:
        """An IMU-initialized map's global pass: FullInertialBA with zero bias
        priors in two chunks of 4 iterations, the abort flag checked before
        each chunk and, inside the solve, before its write-back. No
        propagation: the joint BA writes poses, velocities and biases of the
        keyframes it solved. True when both chunks ran and no abort came."""
        ids = self.map.valid_kf_ids()
        if not len(ids):
            return False
        for _ in range(2):
            if self._abort.is_set():
                return False
            mapper.full_inertial_ba(int(ids[-1]), iters=4, prior_g=0.0, prior_a=0.0,
                                    abort_check=self._abort.is_set)
        return not self._abort.is_set()
