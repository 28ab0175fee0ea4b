"""The port tests' own machinery (tests/torch_port_helpers.py): the run's
persistent JAX compilation cache that every port module turns on and off
(``port_module``), and the JAX references that workers share through files
(``shared_result``).

This module does not import the port's module fixture: it runs as the JAX
package's test modules run, with the cache off, and turns the port module's
setting on and off itself.

Tolerances: none. A program loaded from the cache gives the bits the
compiled one gives, and a shared reference is equal, array for array, to
the same reference computed afresh.
"""
import os
import pickle
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as h


def _program(x, y):
    """A cheap program with the operations a SLAM reference is made of:
    transcendental functions, a matrix product, a reduction, a solve."""
    a = jnp.sin(x) @ jnp.cos(y).T + jnp.exp(-jnp.abs(x[:, :1]))
    g = a.T @ a + 1e-3 * jnp.eye(a.shape[1])
    return jnp.linalg.solve(g, a.sum(0)), jnp.max(a, axis=1)


def _inputs():
    rng = np.random.default_rng(11)
    return (jnp.asarray(rng.normal(size=(48, 24)).astype(np.float32)),
            jnp.asarray(rng.normal(size=(24, 24)).astype(np.float32)))


def _cache_events():
    """A list that collects JAX's persistent cache hit and miss events until
    the listener is removed (returned second)."""
    from jax._src import monitoring
    seen = []

    def listen(event, **_):
        if event.startswith("/jax/compilation_cache/cache_"):
            seen.append(event.rsplit("/", 1)[-1])
    jax.monitoring.register_event_listener(listen)
    return seen, lambda: monitoring.unregister_event_listener(listen)


def test_cache_off_outside_port_modules():
    """The JAX package's test modules see no persistent cache: an earlier
    port module on this worker turned it off again at its teardown."""
    assert jax.config.jax_compilation_cache_dir is None
    assert h._RUN_DIR is None


def test_cached_program_is_bit_equal(tmp_path):
    """A program with the cache off, compiled into the cache (a miss, an
    entry written), and loaded back from it after the in-memory executables
    are dropped (a hit): three bit-equal results."""
    x, y = _inputs()
    off = [np.asarray(v) for v in jax.jit(_program)(x, y)]
    seen, stop = _cache_events()
    try:
        with h.jax_compilation_cache(tmp_path / "cache"):
            jax.clear_caches()
            filled = [np.asarray(v) for v in jax.jit(_program)(x, y)]
            entries = sorted(p.name for p in (tmp_path / "cache").iterdir()
                             if p.name.endswith("-cache"))
            jax.clear_caches()
            loaded = [np.asarray(v) for v in jax.jit(_program)(x, y)]
    finally:
        stop()
    assert entries and any(e.startswith("jit__program") for e in entries), entries
    assert "cache_misses" in seen and "cache_hits" in seen, seen
    for a, b, c in zip(off, filled, loaded):
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(c, a)
    assert jax.config.jax_compilation_cache_dir is None


def test_port_module_setting_is_undone(tmp_path_factory):
    """``port_module`` (the body of the port's autouse module fixture) turns
    the run's cache on, with two torch threads and the run's directory, and
    its exit, the module's teardown, turns every one of them back: a program
    compiled afterwards writes nothing into the run's cache."""
    threads = torch.get_num_threads()
    cache = h.run_dir(tmp_path_factory) / "jax_cache"
    with h.port_module(tmp_path_factory):
        assert jax.config.jax_compilation_cache_dir == str(cache)
        assert torch.get_num_threads() == 2
        assert h._RUN_DIR == h.run_dir(tmp_path_factory)
        x, y = _inputs()
        jax.jit(lambda a, b: _program(a, b)[0] * 2.0)(x, y)
    assert jax.config.jax_compilation_cache_dir is None and h._RUN_DIR is None
    assert torch.get_num_threads() == threads
    assert any(n.endswith("-cache") for n in os.listdir(cache))

    def _compiled_after_teardown(a, b):
        return _program(a, b)[1] * 3.0
    jax.jit(_compiled_after_teardown)(*_inputs())
    # other workers of the run write into the same directory meanwhile: look
    # for this program's own entry
    assert not [n for n in os.listdir(cache) if "compiled_after_teardown" in n]


def test_shared_result_is_computed_once_and_waited_for(tmp_path_factory):
    """Inside a port module: the first call computes and writes; a second
    call loads the file without computing; a worker that finds another's
    lock waits for its result; after a bounded wait, or outside a port
    module, the caller computes itself."""
    calls = []

    def compute():
        calls.append(1)
        return {"a": np.arange(5.0), "b": [np.ones((2, 2), np.float32)]}
    key = f"probe-{os.getpid()}-{time.monotonic_ns()}"
    with h.port_module(tmp_path_factory):
        first = h.shared_result(key, compute)
        second = h.shared_result(key, lambda: pytest.fail("computed twice"))
        np.testing.assert_array_equal(second["a"], first["a"])
        np.testing.assert_array_equal(second["b"][0], first["b"][0])
        assert len(calls) == 1
        # another worker holds the lock and writes its result later
        d = h._RUN_DIR / "shared"
        other = key + "-other"
        (d / f"{other}.lock").touch()

        def write_later():
            time.sleep(0.5)
            with open(d / f"{other}.tmp", "wb") as f:
                pickle.dump("theirs", f)
            os.replace(d / f"{other}.tmp", d / f"{other}.pkl")
        t = threading.Thread(target=write_later)
        t.start()
        assert h.shared_result(other, lambda: "ours") == "theirs"
        t.join()
        # a lock that nobody releases: the wait is bounded
        stuck = key + "-stuck"
        (d / f"{stuck}.lock").touch()
        assert h.shared_result(stuck, lambda: "ours", wait_s=0.5) == "ours"
    assert h.shared_result(key, lambda: "fresh") == "fresh"


def _assert_same(a, b, where="result"):
    """Equal structure, types, dtypes and values (arrays bit for bit)."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


@pytest.mark.parametrize("name", ["room_frames", "depth_rig_stereo", "depth_rig_rgbd"])
def test_shared_references_equal_fresh_ones(tmp_path_factory, name):
    """Every helper that hands workers a result through ``shared_result``:
    what it returns, and what its file holds (written by whichever worker of
    the run came first), equal the same result computed afresh here."""
    if name == "room_frames":
        key, fresh = "room_frames-8-512", lambda: h.room_frames_fresh(8, 512)
        get = lambda: h.room_frames(8, 512)[1]                    # noqa: E731
    else:
        kind = name.split("_")[-1]
        key, fresh = f"depth_rig-{kind}-14", lambda: h.depth_rig_frames_fresh(kind, 14)
        get = lambda: h.depth_rig_inputs(kind, 14)[2]             # noqa: E731
    with h.port_module(tmp_path_factory):
        shared = get()
        with open(h._RUN_DIR / "shared" / f"{key}.pkl", "rb") as f:
            from_file = pickle.load(f)
        computed = fresh()
    assert len(computed) > 0
    _assert_same(shared, computed)
    _assert_same(from_file, computed)


def _traces_of(name):
    """A list that collects one entry per trace of a function called
    ``name`` until the listener is removed (returned second)."""
    from jax._src import monitoring
    seen = []

    def listen(event, duration, fun_name="", **_):
        if event == "/jax/core/compile/jaxpr_trace_duration" and fun_name == name:
            seen.append(duration)
    jax.monitoring.register_event_duration_secs_listener(listen)
    return seen, lambda: monitoring.unregister_event_duration_listener(listen)


def test_shared_local_ba_is_one_program_and_bit_equal():
    """Inside ``shared_jax_local_ba`` a second JAX mapper of the same camera
    type runs its local BA with the first one's jitted callable (no new
    trace), and both give, bit for bit, what a mapper outside it gives."""
    from orbslam3_tpu.models import map as jmap
    from orbslam3_tpu.models.local_mapping import LocalMapper
    from orbslam3_tpu.ops.features import OrbConfig
    m, _, _, n_kf = h.build_drifted_map(jmap)
    K = np.array([458.654, 457.296, 376.0, 240.0], np.float32)
    cfg = OrbConfig(n_features=m.cfg.n_features)

    def run(mapper):
        prob = mapper._gather_local_ba(n_kf // 2)[0]
        return [np.asarray(x) for x in mapper._run_ba(prob, (5, 10))]
    alone = run(LocalMapper(m, K, cfg))
    plain = LocalMapper._run_ba
    traces, stop = _traces_of("local_ba")
    try:
        with h.shared_jax_local_ba():
            a, b = LocalMapper(m, K, cfg), LocalMapper(m, K, cfg)
            first = run(a)
            n_first = len(traces)
            second = run(b)
    finally:
        stop()
    assert n_first >= 1 and len(traces) == n_first, traces
    assert b._ba_jit is a._ba_jit
    assert LocalMapper._run_ba is plain                  # put back at the exit
    _assert_same(first, alone)
    _assert_same(second, alone)

