"""Readings that the limits of `correct` are set from (not run by the
benchmark's own runs).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        [--impostors control half_batch] [--out chiprun_out/x.jsonl]

For each seed, in one process: the cell's set-up (the program's checked
steps; for a cell that checks answers of the window, a short window
reaching every sampled step), then the compared numbers of the program
against the reference, and of each impostor (the reference in the
program's place, at the precision below the cell's or with a planted
fault) against the reference.  One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import run  # noqa: E402
from benchmark.core import spec as specs  # noqa: E402


def readings(workload: str, seeds: list, impostors: list, device=None,
             overrides=None):
    """Yields one line of readings per seed.  A driver whose session can
    `reseed` keeps one session (and, over several cards, one world of
    ranks) for all the seeds."""
    args = run.parse(["--workload", workload, "--seed", str(seeds[0]),
                      "--seconds", "0", "--trace", "0"])
    _, ctx = run.build_context(args, device, overrides)
    ctx.extra["seeds"] = list(seeds)
    driver = specs.load_module("drivers", ctx.cell["driver"])
    session = None
    try:
        for seed in seeds:
            start = time.perf_counter()
            if session is None:
                session = driver.Session(ctx)
            elif hasattr(session, "reseed"):
                session.reseed(seed)
            else:
                session.close()
                ctx.seed = seed
                session = driver.Session(ctx)
            yield one_seed(session, seed, impostors, start)
    finally:
        if session is not None:
            session.close()


def one_seed(session, seed: int, impostors: list, start: float) -> dict:
    need = getattr(session, "sample_steps", None)
    window = (session.window(0, steps=need()) if need is not None
              else {"losses": [], "steps": 0})
    session.memory_peak()
    session.free()
    checks, failed = session.check(window)
    out = {"seed": seed, "program": {k: c["value"]
                                     for k, c in checks.items()},
           "failed": failed}
    for kind in impostors:
        out[kind] = session.impostor(kind)
    detail = getattr(session, "detail", None)
    if detail is not None:
        out["detail"] = detail()
    out["seconds"] = time.perf_counter() - start
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--impostors", nargs="*", default=["control"])
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    sink = open(args.out, "a") if args.out else None
    try:
        for out in readings(args.workload, args.seeds, args.impostors):
            line = json.dumps(out)
            print(line, flush=True)
            if sink:
                print(line, file=sink, flush=True)
            torch.cuda.empty_cache()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
