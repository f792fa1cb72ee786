"""Launch the ranks of a data-parallel test as worker subprocesses.

``run_ranks(args)`` starts ``python <args>`` once per rank with the
environment ``torch.distributed.run`` gives its workers (``RANK``,
``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT`` on a free local port), waits for all of them with one
deadline, and kills every rank if the deadline passes, so that a rank
stuck in a collective cannot hang the suite.  Output goes to files, not
pipes, so that a chatty rank cannot block while another is read.
"""

import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, NamedTuple, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")


class Rank(NamedTuple):
    returncode: int
    stdout: str
    stderr: str


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(args: List[str], world: int = 2, timeout: float = 120.0,
              env: Optional[dict] = None, cwd: str = ROOT) -> List[Rank]:
    """Run ``python *args`` as ``world`` ranks; their results by rank."""
    port = free_port()
    procs, files = [], []
    try:
        for r in range(world):
            e = {**os.environ, **(env or {}),
                 "RANK": str(r), "LOCAL_RANK": str(r),
                 "WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(world),
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                 "OMP_NUM_THREADS": "1",
                 "PYTHONPATH": os.pathsep.join([ROOT, TESTS])}
            out = tempfile.TemporaryFile("w+")
            err = tempfile.TemporaryFile("w+")
            files.append((out, err))
            procs.append(subprocess.Popen([sys.executable, *args], env=e,
                                          cwd=cwd, stdout=out, stderr=err))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{world} ranks of {args} did not finish in "
                             f"{timeout} s:\n" + _tails(files)) from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = []
    for p, (out, err) in zip(procs, files):
        out.seek(0)
        err.seek(0)
        ranks.append(Rank(p.returncode, out.read(), err.read()))
        out.close()
        err.close()
    return ranks


def _tails(files) -> str:
    parts = []
    for r, (_, err) in enumerate(files):
        err.seek(0)
        parts.append(f"rank {r} stderr:\n{err.read()[-3000:]}")
    return "\n".join(parts)


def check_ranks(ranks: List[Rank]) -> List[Rank]:
    """Fail with the ranks' errors unless every rank exited with 0."""
    bad = [f"rank {r} exited {x.returncode}:\n{x.stderr[-4000:]}"
           for r, x in enumerate(ranks) if x.returncode != 0]
    assert not bad, "\n".join(bad)
    return ranks
