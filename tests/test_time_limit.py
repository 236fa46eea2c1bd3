"""The suite's time limit and schedule (conftest.py at the repo's root)."""

import pathlib
import signal
import subprocess
import sys
import threading
import time
import types

import pytest


@pytest.fixture
def suite(request):
    """The root conftest.py, as pytest registered it."""
    return request.config.pluginmanager.get_plugin(
        str(request.config.rootpath / "conftest.py"))


def test_time_limit_stops_a_test_that_runs_past_it(suite, capfd):
    # The limit is a SIGALRM, which only the main thread receives: each
    # pytest-xdist worker runs its tests there.
    assert threading.current_thread() is threading.main_thread()
    start = time.monotonic()
    # This replaces the limit that conftest.py armed around this test.
    with pytest.raises(suite.TimeLimitExceeded):
        with suite.time_limit(1):
            time.sleep(5)
    assert time.monotonic() - start < 2
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
    assert "test_time_limit_stops_a_test_that_runs_past_it" in \
        capfd.readouterr().err


def test_hung_children_are_killed_when_the_limit_stops_the_test(suite):
    # The wait of the JAX package's two-process tests: one child after the
    # other, each with a timeout of its own.
    procs = []
    start = time.monotonic()
    with pytest.raises(suite.TimeLimitExceeded):
        with suite.time_limit(2), suite.killing_new_processes():
            for _ in range(2):
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", "import time; time.sleep(60)"]))
            for p in procs:
                p.communicate(timeout=540)
    assert [p.wait(timeout=5) for p in procs] == [-signal.SIGKILL] * 2
    assert time.monotonic() - start < 10


class _Node:
    def __init__(self, name):
        self.gateway = types.SimpleNamespace(id=name)
        self.shutting_down = False
        self.sent = []

    def send_runtest_some(self, indices):
        self.sent.extend(indices)

    def shutdown(self):
        self.shutting_down = True


def test_schedule_splits_compile_bound_files_and_runs_a_crash_once(suite):
    pytest.importorskip("xdist")
    config = types.SimpleNamespace(
        option=types.SimpleNamespace(loadscopereorder=True),
        getvalue={"dist": "loadfile", "tx": ["2*popen"]}.get)
    sched = suite.pytest_xdist_make_scheduler(config=config, log=None)
    collection = ["tests/test_sharding.py::test_a[2]",
                  "tests/test_sharding.py::test_a[8]",
                  "tests/test_sharding.py::test_b",
                  "tests/test_sharding.py::test_c",
                  "tests/test_other.py::test_d",
                  "tests/test_other.py::test_e",
                  "tests/test_more.py::test_f"]
    nodes = [_Node("gw0"), _Node("gw1")]
    for node in nodes:
        sched.add_node(node)
        sched.add_node_collection(node, collection)
    sched.schedule()
    # Each test function of a compile-bound file is a unit, another file
    # is one; a node that holds a compile-bound unit takes the next unit
    # of another file.
    assert nodes[0].sent == [0, 1, 4, 5]
    assert nodes[1].sent == [2, 6]
    assert list(sched.workqueue) == ["tests/test_sharding.py::test_c"]
    # nodes[1] goes down during test_b: its other work is queued again,
    # test_b is not.
    assert sched.remove_node(nodes[1]) == "tests/test_sharding.py::test_b"
    assert list(sched.workqueue) == ["tests/test_sharding.py::test_c",
                                     "tests/test_more.py"]
    assert sched.workqueue["tests/test_more.py"] == {
        "tests/test_more.py::test_f": False}


def test_collection_order(suite):
    def item(path, function):
        return types.SimpleNamespace(path=pathlib.Path(path), name=function,
                                     originalname=function)

    slowest = [item(f"tests/{s.split('::')[0]}", s.split("::")[1])
               for s in suite.SLOWEST[:2]]
    items = [item("tests/test_torch_x.py", "test_p"),
             item("tests/test_many.py", "test_m1"),
             item("tests/test_many.py", "test_m2"),
             item("tests/test_one.py", "test_o"),
             item("tests/test_sharding.py", "test_s"),
             slowest[1],
             item("tests/test_grads.py", "test_g"),
             slowest[0]]
    suite.pytest_collection_modifyitems(items)
    assert [(i.path.name, i.originalname) for i in items] == [
        (s.path.name, s.originalname) for s in slowest] + [
        ("test_sharding.py", "test_s"), ("test_grads.py", "test_g"),
        ("test_one.py", "test_o"), ("test_many.py", "test_m1"),
        ("test_many.py", "test_m2"), ("test_torch_x.py", "test_p")]
