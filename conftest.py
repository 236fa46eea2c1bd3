"""The test suite's time limit and schedule, for the JAX package's tests and
the port's alike.

- Every test runs under a time limit of LIMIT seconds, set-up and tear-down
  included. Past it the test fails with every thread's stack, and the
  processes it started and left running are killed.
- Under pytest-xdist's `--dist loadfile`, the test functions of the JAX
  package's compile-bound files (COMPILE_BOUND) are handed to the workers
  one at a time, the slowest (SLOWEST) first, and a worker holds one of
  them at a time; every other file still goes to one worker whole.

This file imports the standard library and pytest alone (xdist inside the
hook that needs it), so neither package's tests depend on the other.
"""

import collections
import contextlib
import faulthandler
import os
import signal
import sys

import pytest

# Each test's time limit in seconds, set-up and tear-down included: about
# twice the slowest test of a cold-cache tier-1 run (ROADMAP "Test budget").
LIMIT = 1200

# The JAX package's test files bound by XLA:CPU compiles of minutes: each of
# their test functions (its parameter cases together) is a unit of its own.
COMPILE_BOUND = ("test_sharding.py", "test_grads.py", "test_compaction.py",
                 "test_pallas_quad.py")

# Of those, the test functions of a minute or more on a cold compile cache,
# slowest first (ROADMAP's tier-1 command on 8 CPUs: 300-640 s for the
# first six, 70-330 s for the rest). Handed out first, none of them starts late
# and sets the end of the run.
SLOWEST = (
    "test_sharding.py::test_sharded_grads_through_mosaic_kernel",
    "test_sharding.py::test_sharded_tape_matches_sharded_plain",
    "test_sharding.py::test_sharded_replay_matches_sharded_plain",
    "test_sharding.py::test_sharded_grads_match_unsharded",
    "test_sharding.py::test_sharded_tape_divergent_chunk_branches",
    "test_sharding.py::test_sharded_tape_through_quad_with_compaction",
    "test_grads.py::test_tape_matches_replay_quad_kernel",
    "test_grads.py::test_grads_through_accel_traversals",
    "test_sharding.py::test_sharded_with_mosaic_kernels",
    "test_compaction.py::test_compact_render_identical",
    "test_pallas_quad.py::test_end_to_end_render",
)


class TimeLimitExceeded(Exception):
    pass


@contextlib.contextmanager
def time_limit(seconds):
    """Fail the code inside when it runs past `seconds`.

    A SIGALRM dumps every thread's stack and raises TimeLimitExceeded in
    the main thread, where pytest-xdist runs each test. A signal handler
    runs only between Python bytecodes, so a thread stuck in native code
    (an XLA compile or collective) is caught 60 s later by faulthandler,
    which dumps the stacks and ends the process."""

    def expired(signum, frame):
        faulthandler.dump_traceback(all_threads=True)
        raise TimeLimitExceeded(f"ran past its time limit of {seconds} s")

    previous = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    # The backstop writes to standard error as it is now: pytest's capture
    # puts a file of its own on fd 2 while the test runs, and that file is
    # lost with the process.
    backstop = os.dup(sys.stderr.fileno())
    faulthandler.dump_traceback_later(seconds + 60, exit=True, file=backstop)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        os.close(backstop)
        signal.signal(signal.SIGALRM, previous)


def descendants(pid):
    """The live processes below `pid`, read from /proc (Linux)."""
    parent = {}
    for entry in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except (OSError, IndexError):
            continue
        if fields[0] != "Z":
            parent[int(entry)] = int(fields[1])
    found, frontier = set(), {pid}
    while frontier:
        frontier = {p for p, pp in parent.items() if pp in frontier} - found
        found |= frontier
    return found


@contextlib.contextmanager
def killing_new_processes():
    """Kill the processes started inside when the code inside raises.

    A test that waits on child processes one after another leaves the rest
    running when a wait gives up or the time limit stops it."""
    before = descendants(os.getpid())
    try:
        yield
    except BaseException:
        for pid in descendants(os.getpid()) - before:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGKILL)
        raise


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    with time_limit(LIMIT):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with killing_new_processes():
        return (yield)


def pytest_collection_modifyitems(items):
    """Hand out SLOWEST first, in its order, then the rest of COMPILE_BOUND,
    then the JAX package's other files, then the port's, and of each of the
    last two the files with the fewest tests first.

    Here a file's test count runs against its cost: the port's files hold
    many cases of a second or less (most skip without a card), while the
    JAX package's hold a few tests, each bound by a compile. Handed out
    last, those would run one after another at the end of the run."""
    count = collections.Counter(item.path for item in items)

    def order(item):
        name = item.path.name
        function = f"{name}::{getattr(item, 'originalname', item.name)}"
        if function in SLOWEST:
            return 0, SLOWEST.index(function)
        if name in COMPILE_BOUND:
            return 1, COMPILE_BOUND.index(name)
        return 2 + name.startswith("test_torch_"), count[item.path]

    items.sort(key=order)


@pytest.hookimpl(tryfirst=True, optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class Scheduling(LoadFileScheduling):
        """`--dist loadfile`, but each test function of COMPILE_BOUND is a
        unit of its own, a node holds one of them at a time, the units go
        out in the collection's order, and a test that takes its worker
        down is not run again."""

        def _split_scope(self, nodeid):
            path = nodeid.split("::", 1)[0]
            if os.path.basename(path) in COMPILE_BOUND:
                return nodeid.split("[", 1)[0]
            return path

        def _assign_work_unit(self, node):
            # A worker takes its next test before it runs the one it has,
            # so a unit queued behind a compile of minutes waits for it.
            # A node that holds a compile-bound unit (the only scopes with
            # "::") takes the next unit of another file instead.
            if any("::" in scope and not all(unit.values())
                   for scope, unit in self.assigned_work[node].items()):
                other = next((s for s in self.workqueue if "::" not in s),
                             None)
                if other is not None:
                    self.workqueue.move_to_end(other, last=False)
            super()._assign_work_unit(node)

        def remove_node(self, node):
            # As LoadScopeScheduling.remove_node, but the test that was
            # running when the node went down is marked done before the
            # node's other work goes back into the queue: queued again, a
            # test stopped by time_limit's backstop would take down each
            # worker that takes it next.
            workload = self.assigned_work.pop(node)
            pending = [(scope, nodeid) for scope, unit in workload.items()
                       for nodeid, done in unit.items() if not done]
            if not pending:
                return None
            scope, crashitem = pending[0]
            workload[scope][crashitem] = True
            self.workqueue.update((scope, unit)
                                  for scope, unit in workload.items()
                                  if not all(unit.values()))
            for other in self.assigned_work:
                self._reschedule(other)
            return crashitem

    config.option.loadscopereorder = False
    return Scheduling(config, log)
