"""Per-file test-seconds of a pytest run and the wall time its
``pytest-xdist --dist loadfile`` schedule gives them.

    python scripts/tier1_schedule.py RUN.xml [--workers 6] [--tail 10]

``RUN.xml`` is the ``--junitxml`` of a run. The script prints each test
file's test-seconds and number of tests, then replays xdist's load-file
scheduler over those times: files queued by their number of tests, most
first (its default ``--loadscope-reorder``; ties in collection order),
one file to each worker, and a worker takes the next file once two or
fewer of its assigned tests are left. It prints the simulated end of the
run and the files that end last, with their start times. Worker start-up
and collection are not in the model, so a real run ends somewhat later.
"""

from __future__ import annotations

import argparse
import collections
import heapq
import xml.etree.ElementTree as ET


def load(path: str) -> "collections.OrderedDict[str, list]":
    """{test file: [(test name, seconds), ...]} in the XML's order."""
    files: collections.OrderedDict = collections.OrderedDict()
    for case in ET.parse(path).getroot().iter("testcase"):
        module = (case.get("classname") or "").split(".")[-1]
        files.setdefault(module, []).append((case.get("name"), float(case.get("time") or 0.0)))
    return files


def simulate(files, workers: int = 6):
    """(end of the run, {file: (start, end)}) under the load-file queue."""
    queue = sorted(sorted(files), key=lambda name: -len(files[name]))
    pending = [[] for _ in range(workers)]
    position = 0
    spans = {}

    def assign(worker):
        nonlocal position
        if position < len(queue):
            name = queue[position]
            position += 1
            pending[worker].extend((name, seconds) for _, seconds in files[name])

    for worker in range(workers):
        assign(worker)
    for worker in range(workers):
        if len(pending[worker]) <= 2:
            assign(worker)
    clock = [0.0] * workers
    events = [(pending[w][0][1], w) for w in range(workers) if pending[w]]
    heapq.heapify(events)
    end = 0.0
    while events:
        now, worker = heapq.heappop(events)
        name, seconds = pending[worker].pop(0)
        start = spans.get(name, (now - seconds, now))[0]
        spans[name] = (start, now)
        clock[worker] = now
        end = max(end, now)
        if len(pending[worker]) <= 2:
            assign(worker)
        if pending[worker]:
            heapq.heappush(events, (clock[worker] + pending[worker][0][1], worker))
    return end, spans


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("xml")
    parser.add_argument("--workers", type=int, default=6)
    parser.add_argument("--tail", type=int, default=10)
    args = parser.parse_args()
    files = load(args.xml)
    totals = {name: sum(seconds for _, seconds in tests) for name, tests in files.items()}
    for name in sorted(totals, key=totals.get, reverse=True):
        print(f"{totals[name]:9.1f} s {len(files[name]):5d} tests  {name}")
    total = sum(totals.values())
    end, spans = simulate(files, args.workers)
    print(f"{total:9.1f} test-seconds; /{args.workers} = {total / args.workers:.1f} s; "
          f"simulated end of the run {end:.1f} s")
    for name, (start, stop) in sorted(spans.items(), key=lambda item: -item[1][1])[:args.tail]:
        print(f"  ends {stop:7.1f} s (started {start:7.1f}): {name} ({len(files[name])} tests, "
              f"{totals[name]:.1f} s)")


if __name__ == "__main__":
    main()
