"""Start the ranks of a multi-process job on this machine and wait for all.

No JAX counterpart (a JAX job is started by whoever runs it).  Used by
`entry.dryrun_multichip`, the tests and the smoke script: every rank is
its own Python process, each is given the same time limit, and a rank
that fails or runs out of time fails the whole job with its output shown;
the others are then stopped, so no rank is left waiting on a collective.
"""

from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time


def free_port() -> int:
    """A TCP port free on localhost now (for the rendezvous)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class RankFailure(RuntimeError):
    pass


def run_ranks(cmds, timeout: float, env=None, cwd=None) -> list:
    """Run one command per rank, all at once; return each rank's output
    (standard output and error together) once every rank exited 0.

    Raises RankFailure, with the output of every rank, when a rank exits
    non-zero or the ranks are not all done within `timeout` seconds; the
    ranks still running are killed first."""
    # Output goes to files, not pipes: a rank that prints more than a pipe
    # holds must not block while the others are polled.
    logs = [tempfile.TemporaryFile(mode="w+") for _ in cmds]
    procs = [subprocess.Popen(c, stdout=f, stderr=subprocess.STDOUT,
                              text=True, cwd=cwd,
                              env=env if env is not None else dict(os.environ))
             for c, f in zip(cmds, logs)]
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.returncode not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                break
            if time.monotonic() > deadline:
                failed = f"ranks not done within {timeout} s"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
    if failed is None:
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
    if failed is not None:
        text = "\n".join(f"--- rank {r} (exit {p.returncode}) ---\n"
                         f"{o[-6000:]}"
                         for r, (p, o) in enumerate(zip(procs, outs)))
        raise RankFailure(f"{failed}\n{text}")
    return outs
