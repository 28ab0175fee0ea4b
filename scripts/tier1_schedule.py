"""Replay a tier-1 run's test times through pytest-xdist's ``--dist loadfile``
schedule, to see what sets the run's wall time.

    python3 scripts/tier1_schedule.py RUN.xml [--reference REF.xml] [--workers 6]

RUN.xml is the junit file of a run of the tier-1 command. pytest-xdist
(3.8, ``--loadscope-reorder`` on by default) queues the test files by their
number of tests, most first (files with equal counts in collection order),
gives each worker one file and then another whenever two or fewer of its
tests are left, and a worker runs its tests one after another. The replay
prints the makespan it predicts (without collection and start-up) and the
files that end last.

With ``--reference`` (the junit file of another run, e.g. an earlier commit
on another host) the replay first divides RUN's times by the ratio of the
two runs' totals over the files that exist in both and belong to the JAX
package (``tests/test_*.py`` that are not ``test_torch_*``): an estimate of
RUN on the reference run's host, where host load differs between runs.
"""
import argparse
import collections
import heapq
import xml.etree.ElementTree as ET


def load(path: str) -> "collections.OrderedDict[str, list]":
    files = collections.OrderedDict()
    for tc in ET.parse(path).iter("testcase"):
        files.setdefault(tc.get("classname").rsplit(".", 1)[-1], []).append(
            float(tc.get("time", 0.0)))
    return files


def replay(files: dict, workers: int = 6):
    """Returns (makespan, {file: (end time, worker)})."""
    queue = collections.deque(sorted(sorted(files), key=lambda f: -len(files[f])))
    pending = {w: collections.deque() for w in range(workers)}

    def assign(w):
        if queue:
            f = queue.popleft()
            pending[w].extend((f, t) for t in files[f])

    for w in range(workers):
        assign(w)
    for w in range(workers):
        if len(pending[w]) <= 2:
            assign(w)
    clock = [(0.0, w) for w in range(workers)]
    heapq.heapify(clock)
    ends = {}
    while clock:
        now, w = heapq.heappop(clock)
        if not pending[w]:
            continue
        f, t = pending[w].popleft()
        ends[f] = (now + t, w)
        if len(pending[w]) <= 2:
            assign(w)
        heapq.heappush(clock, (now + t, w))
    return max(e for e, _ in ends.values()), ends


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run")
    ap.add_argument("--reference")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--last", type=int, default=8, help="files to list that end last")
    opt = ap.parse_args()
    files = load(opt.run)
    total = sum(sum(v) for v in files.values())
    print(f"{opt.run}: {sum(len(v) for v in files.values())} tests in {len(files)} files, "
          f"junit total {total:.1f} s")
    if opt.reference:
        ref = load(opt.reference)
        both = [f for f in files if f in ref and not f.startswith("test_torch")]
        ratio = sum(sum(files[f]) for f in both) / sum(sum(ref[f]) for f in both)
        files = {f: [t / ratio for t in v] for f, v in files.items()}
        print(f"host ratio against {opt.reference} over {len(both)} JAX-package files: "
              f"{ratio:.3f}; scaled junit total {total / ratio:.1f} s")
    span, ends = replay(files, opt.workers)
    print(f"replayed makespan over {opt.workers} workers: {span:.1f} s")
    for f, (end, w) in sorted(ends.items(), key=lambda kv: kv[1][0])[-opt.last:]:
        print(f"  ends {end:7.1f} s on worker {w}: {f} ({len(files[f])} tests, "
              f"{sum(files[f]):.1f} s)")


if __name__ == "__main__":
    main()
