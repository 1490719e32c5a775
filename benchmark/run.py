"""Run one cell of the port's benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

With --trace 0 it measures the cell's end-to-end metrics over a window of
whole units of work run back to back for --seconds; with --trace 1 it
profiles the cell's traced slice and reports its per-layer metrics. Either
way it then checks what the timed path produced against the plain
reference (benchmark/compare.py) and prints, as the last line of standard
output, one JSON object: correct, attempted, failed, metrics, device (and
breakdown when traced), and last the numbers compared with their limits,
which also end standard error.

It needs CUDA cards, as many as the cell's chips; without them it exits
with code 1 and prints no result. A four-chip cell runs one process a card:
this process is rank 0 and starts the others (torch.distributed over NCCL,
rendezvous on a free localhost port). Every process of a run starts alike:
one thread for PyTorch's CPU operations, and pinned to its rank's equal
share of the CPUs the run may use (all of them on one card).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

# set before torch is imported, in every process of a run, so that its
# thread pools start at one thread
os.environ.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the CPUs this run may use, as the process started with them
CPUS = sorted(os.sched_getaffinity(0))


def cpu_share(rank: int, world: int) -> list:
    """Rank's equal share of CPUS, in order: all of them on one card."""
    k = max(1, len(CPUS) // world)
    return CPUS[rank * k:(rank + 1) * k] or CPUS


def _pin(rank: int, world: int) -> None:
    """Pins this process to its share of CPUS: the threads it starts from
    here on inherit the share."""
    os.sched_setaffinity(0, cpu_share(rank, world))


def _chips(workload: str) -> int:
    """The cell's chips, read without torch: a process is pinned before
    torch starts its threads."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = {w["name"]: w for w in json.load(f)["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    return int(cells[workload]["chips"])


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start_ranks(args, world: int, port: int) -> list:
    """Starts ranks 1..world-1 with this process's environment and all of
    CPUS, of which each takes its own share."""
    cmd = [sys.executable, "-m", "benchmark.run", "--workload", args.workload, "--seed",
           str(args.seed), "--seconds", str(args.seconds), "--trace", str(args.trace),
           "--world", str(world), "--port", str(port)]
    os.sched_setaffinity(0, CPUS)
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], stdout=subprocess.DEVNULL)
             for r in range(1, world)]
    _pin(0, world)
    return procs


def _watch(procs: list) -> None:
    """Ends this process when a rank fails, rather than wait on NCCL."""
    while True:
        for p in procs:
            rc = p.poll()
            if rc not in (None, 0):
                print(f"rank process {p.args[-1]} exited with {rc}", file=sys.stderr, flush=True)
                for q in procs:
                    if q.poll() is None:
                        q.kill()
                os._exit(1)
        if all(p.poll() == 0 for p in procs):
            return
        time.sleep(0.5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # set only on the processes rank 0 starts
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    world = args.world or _chips(args.workload)
    _pin(args.rank, world)

    import torch

    from benchmark import harness

    if args.rank == 0:
        if not torch.cuda.is_available() or torch.cuda.device_count() < world:
            print(f"{args.workload} needs {world} CUDA card(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 1
    procs = []
    if args.rank == 0 and world > 1:
        args.port = _free_port()
        procs = _start_ranks(args, world, args.port)
        threading.Thread(target=_watch, args=(procs,), daemon=True).start()
    try:
        out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=T_START, rank=args.rank, world=world,
                          port=args.port)
    finally:
        for p in procs:
            try:
                p.wait(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    if out is None:
        return 0
    if any(p.returncode != 0 for p in procs):
        return 1
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {', '.join(found)}",
              file=sys.stderr)
        return 1
    result, lines = out
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
