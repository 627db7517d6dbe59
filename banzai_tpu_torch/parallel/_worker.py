"""One rank of a multi-process encode.

    python -m banzai_tpu_torch.parallel._worker <rank> <nproc> <port> \\
        <input> <output> <level> [--device D] [--report PATH]

Run once per rank.  Joins a gloo process group at ``127.0.0.1:<port>``
(``nproc`` ranks), encodes ``<input>`` with
``multihost.encode_multihost_path`` on ``--device`` (default one card
per rank, ``cuda:<rank % cards>``), and rank 0 writes the stream to ``<output>`` and, with ``--report``, the
report as JSON.  Every rank prints one JSON line: its rank, devices,
the kernel launches of its encode, and under ``at`` the epoch times at
which ``main`` started and torch was imported, the devices' contexts and
the kernel library were loaded, the group was joined and the encode was
done.  On the CPU each rank keeps to 2 intra-op threads, so several
ranks on one host do not oversubscribe it.

``run_ranks`` starts one such process per rank on this host and waits
for all of them: the multi-process tests and ``chip_smoke.py`` use it.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]   # the package's parent


def default_device(rank: int) -> str:
    """One card per rank, ``cuda:<rank % cards>``; ``"cuda"`` (which
    raises when it is resolved) where no card is visible."""
    import torch

    ncard = torch.cuda.device_count()
    return f"cuda:{rank % ncard}" if ncard else "cuda"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("nproc", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("level", type=int, choices=range(1, 10))
    ap.add_argument("--device")
    ap.add_argument("--report")
    args = ap.parse_args(argv)
    at = {"main": time.time()}

    import torch
    import torch.distributed as dist

    from .. import _build
    from .dp import block_devices
    from .multihost import encode_multihost_path

    at["torch"] = time.time()
    if args.device is None:
        args.device = default_device(args.rank)
    devs = block_devices(args.device)
    if devs[0].type == "cpu":
        torch.set_num_threads(2)
    else:
        for d in devs:
            torch.zeros(1, device=d)        # the card's context
        _build.library()
    at["device"] = time.time()
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{args.port}",
        world_size=args.nproc, rank=args.rank,
    )
    try:
        at["group"] = time.time()
        _build.LAUNCHES.clear()
        report: dict = {}
        out = encode_multihost_path(args.input, args.level, report=report,
                                    device=args.device)
        at["done"] = time.time()
        if args.rank == 0:
            with open(args.output, "wb") as f:
                f.write(out)
            if args.report:
                with open(args.report, "w") as f:
                    json.dump(report, f, indent=1)
        print(json.dumps({
            "rank": args.rank, "device": [str(d) for d in devs],
            "launches": dict(_build.LAUNCHES), "at": at,
        }), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(
    input_path: str,
    output_path: str,
    level: int,
    devices: list[str],
    report_path: str | None = None,
    timeout: float = 600.0,
) -> list[dict]:
    """Run one rank per entry of ``devices`` (rank r on ``devices[r]``) as
    processes of this host on a free localhost port, and wait for all.

    Returns each rank's JSON line, with ``at["spawned"]`` (the epoch
    time just before the ranks were started) added.  A rank that exits
    non-zero, or a run past ``timeout`` seconds, kills every rank and
    raises with the stderr tails; no process is left running."""
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(_ROOT), env.get("PYTHONPATH")) if p)
    nproc = len(devices)
    procs, outs, errs = [], [], []
    spawned_at = time.time()
    try:
        for rank, dev in enumerate(devices):
            cmd = [sys.executable, "-m", "banzai_tpu_torch.parallel._worker",
                   str(rank), str(nproc), str(port), str(input_path),
                   str(output_path), str(level), "--device", dev]
            if report_path is not None:
                cmd += ["--report", str(report_path)]
            outs.append(tempfile.TemporaryFile())
            errs.append(tempfile.TemporaryFile())
            procs.append(subprocess.Popen(cmd, cwd=_ROOT, env=env,
                                          stdout=outs[-1], stderr=errs[-1]))

        def tail(r: int) -> str:
            errs[r].seek(0)
            return errs[r].read().decode(errors="replace")[-2000:]

        deadline = time.monotonic() + timeout
        while True:
            rcs = [p.poll() for p in procs]
            bad = [r for r, rc in enumerate(rcs) if rc not in (None, 0)]
            if bad:
                r = bad[0]
                raise RuntimeError(f"rank {r} exited {rcs[r]}: {tail(r)}")
            if all(rc == 0 for rc in rcs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"ranks not done after {timeout} s; stderr: "
                    + " | ".join(tail(r) for r in range(nproc)))
            time.sleep(0.05)
        lines = []
        for f in outs:
            f.seek(0)
            line = json.loads(f.read().decode().strip().splitlines()[-1])
            line["at"]["spawned"] = spawned_at
            lines.append(line)
        return lines
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in outs + errs:
            f.close()


if __name__ == "__main__":
    sys.exit(main())
