"""Where a tier-1 run's time goes, per test module: a pytest plugin and its
report.

As a plugin (loaded with ``-p tier1_probe``, ``scripts/`` on PYTHONPATH),
each pytest process (each xdist worker) records per test module:

- the JAX program building that ``jax.monitoring`` reports on the main
  thread: the time spans of ``jaxpr_trace_duration`` (tracing),
  ``jaxpr_to_mlir_module_duration`` (lowering) and
  ``backend_compile_duration`` (compiling, a persistent-cache read
  included), nested spans merged, with their counts, and the seconds and
  count of ``cache_retrieval_time_sec`` (reads from the persistent
  compilation cache);
- a 20 ms sampler of the main thread's stack, which files each sample under
  the innermost frame it knows: ``jax`` (the JAX package or JAX itself),
  ``port`` (orbslam3_tpu_torch or PyTorch), ``render`` (the synthetic
  scenes' renderer), ``wait`` (``torch_port_helpers.shared_result`` waiting
  for another worker) or ``other``.

JAX execution is then the ``jax`` samples less the building. Each process
writes ``<dir>/<worker>.<pid>.json`` after every test.

    python3 -m pytest ... -p tier1_probe --tier1-probe-out DIR
    python3 scripts/tier1_probe.py DIR RUN.xml [--all]

The report prints one row per test module of the port (``--all``: every
module) with the junit seconds and test count of RUN.xml, the run's junit
file.
"""
import argparse
import collections
import glob
import json
import os
import sys
import threading
import time

_EVENTS = {"/jax/core/compile/jaxpr_trace_duration": "trace",
           "/jax/core/compile/jaxpr_to_mlir_module_duration": "lower",
           "/jax/core/compile/backend_compile_duration": "compile"}
_RETRIEVAL = "/jax/compilation_cache/cache_retrieval_time_sec"
_MAIN = threading.main_thread().ident
_lock = threading.Lock()
_state = {"module": None, "out": None}
_stats = collections.defaultdict(collections.Counter)
_spans = collections.defaultdict(list)


def _on_span(event, start, end, **_):
    cat = _EVENTS.get(event)
    module = _state["module"]
    if cat is None or module is None or threading.get_ident() != _MAIN:
        return
    with _lock:
        _spans[module, cat].append((start, end))
        _stats[module][cat + "_n"] += 1


def _on_duration(event, duration, **_):
    module = _state["module"]
    if event == _RETRIEVAL and module is not None:
        with _lock:
            _stats[module]["retrieval"] += duration
            _stats[module]["retrieval_n"] += 1


def _classify(frame) -> str:
    if frame is not None and frame.f_code.co_name == "shared_result":
        return "wait"
    while frame is not None:
        path, name = frame.f_code.co_filename, frame.f_code.co_name
        if "/orbslam3_tpu_torch/" in path or "/site-packages/torch/" in path:
            return "port"
        if "/orbslam3_tpu/" in path:
            return "render" if path.endswith("datasets.py") else "jax"
        if "/site-packages/jax/" in path or "/jaxlib/" in path:
            return "jax"
        if path.endswith("torch_port_helpers.py") and name in ("render_all", "one"):
            return "render"
        frame = frame.f_back
    return "other"


def _sample(period=0.02):
    last = time.perf_counter()
    while True:
        time.sleep(period)
        now = time.perf_counter()
        elapsed, last = now - last, now
        module = _state["module"]
        if module is not None:
            cat = _classify(sys._current_frames().get(_MAIN))
            with _lock:
                _stats[module]["s_" + cat] += elapsed


def _merged(spans) -> float:
    total, lo, hi = 0.0, None, None
    for s, e in sorted(spans):
        if lo is None or s > hi:
            total += 0.0 if lo is None else hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    return total + (0.0 if lo is None else hi - lo)


def _dump():
    with _lock:
        out = {m: dict(v) for m, v in _stats.items()}
        for (m, cat), spans in _spans.items():
            out.setdefault(m, {})[cat] = _merged(spans)
    name = f"{os.environ.get('PYTEST_XDIST_WORKER', 'main')}.{os.getpid()}"
    tmp = os.path.join(_state["out"], name + ".tmp")
    with open(tmp, "w") as f:
        json.dump(out, f)
    os.replace(tmp, os.path.join(_state["out"], name + ".json"))


def pytest_addoption(parser):
    parser.addoption("--tier1-probe-out", default=None,
                     help="directory for the per-module JSON files of tier1_probe")


def pytest_sessionstart(session):
    out = session.config.getoption("--tier1-probe-out")
    if not out:
        return
    import jax.monitoring
    os.makedirs(out, exist_ok=True)
    _state["out"] = out
    jax.monitoring.register_event_time_span_listener(_on_span)
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    threading.Thread(target=_sample, daemon=True).start()


def pytest_runtest_logstart(nodeid, location):
    if _state["out"]:
        _state["module"] = nodeid.split("::")[0].rsplit("/", 1)[-1][:-3]


def pytest_runtest_logfinish(nodeid, location):
    if _state["out"]:
        _dump()


def report(directory: str, junit: str, every: bool = False):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tier1_schedule import load
    files = load(junit)
    probe = collections.defaultdict(collections.Counter)
    for path in glob.glob(os.path.join(directory, "*.json")):
        with open(path) as f:
            for module, values in json.load(f).items():
                probe[module].update(values)
    port = {m: v for m, v in files.items() if m.startswith("test_torch")}
    total, port_total = sum(map(sum, files.values())), sum(map(sum, port.values()))
    print(f"{junit}: junit {total:.1f} s; the port's {len(port)} files {port_total:.1f} s; "
          f"the JAX package's {len(files) - len(port)} files {total - port_total:.1f} s")
    print("| module | tests | junit s | JAX building s: trace / lower / compile (cache reads s) "
          "| programs: compiled or read / read | JAX execution s | port s | render s "
          "| shared_result wait s |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- |")
    for module, times in sorted(files.items(), key=lambda kv: -sum(kv[1])):
        if not (every or module.startswith("test_torch")):
            continue
        p = probe.get(module, collections.Counter())
        build = p["trace"] + p["lower"] + p["compile"]
        print(f"| {module[5:]} | {len(times)} | {sum(times):.1f} | {build:.1f}: "
              f"{p['trace']:.1f} / {p['lower']:.1f} / {p['compile']:.1f} ({p['retrieval']:.1f}) "
              f"| {int(p['compile_n'])} / {int(p['retrieval_n'])} "
              f"| {max(p['s_jax'] - build, 0.0):.1f} | {p['s_port']:.1f} | {p['s_render']:.1f} "
              f"| {p['s_wait']:.1f} |")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("directory")
    ap.add_argument("junit")
    ap.add_argument("--all", action="store_true", help="also the JAX package's modules")
    opt = ap.parse_args()
    report(opt.directory, opt.junit, opt.all)


if __name__ == "__main__":
    main()
