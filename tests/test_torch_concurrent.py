"""The port's concurrency layer (``ct_icp_torch/odometry/concurrent.py``):
the cases of tests/test_concurrent_checkpoint.py::TestConcurrency, and the
registration actor on the CPU against a direct run of the same frames."""

import time

import numpy as np
import pytest
import torch

from ct_icp_torch.odometry import concurrent as cc


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """One torch thread: the plain kernels run many small ops, and the other
    test workers keep the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_blocking_queue():
    q = cc.BlockingQueue(capacity=4)
    for i in range(4):
        q.push(i)
    assert len(q) == 4
    assert q.pop() == 0


def test_prefetch_iterator_order_and_transform():
    it = cc.PrefetchIterator(range(20), depth=4, transform=lambda x: x * 2)
    assert list(it) == [2 * i for i in range(20)]


def test_prefetch_without_transform():
    assert list(cc.PrefetchIterator(iter("abc"), depth=1)) == ["a", "b", "c"]


def test_prefetch_propagates_errors():
    def bad():
        yield 1
        raise ValueError("boom")
    it = cc.PrefetchIterator(bad(), depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError):
        list(it)


def test_actor_processes_serially():
    seen = []
    a = cc.Actor()
    a.register_handler(int, seen.append)
    for i in range(10):
        a.send(i)
    a.send("ignored: no handler for str")
    a.stop()
    assert seen == list(range(10))


def test_notifier():
    n = cc.Notifier()
    got = []
    n.subscribe(got.append)
    n.subscribe(lambda x: got.append(-x))
    n.notify(42)
    assert got == [42, -42]


def test_scheduler_fires():
    count = [0]
    s = cc.Scheduler(0.02, lambda: count.__setitem__(0, count[0] + 1))
    s.start()
    time.sleep(0.15)
    s.stop()
    assert count[0] >= 3


def test_registration_actor_matches_direct_run():
    """Frames sent to a RegistrationActor register in order on its thread;
    the summaries it publishes and the trajectory equal a direct run's."""
    from tests.torch_runner_cases import frames as make_frames
    from tests.torch_runner_cases import options_pair
    from ct_icp_torch.odometry.odometry import Odometry

    frames, opts = make_frames(5, 3), options_pair()[1]
    direct = Odometry(opts, device="cpu")
    for i, fr in enumerate(frames):
        direct.register_frame(fr["xyz"], fr["timestamps"], frame_id=i)
    actor = cc.RegistrationActor(Odometry(opts, device="cpu"))
    got = []
    actor.output.subscribe(got.append)
    for i, fr in enumerate(frames):
        actor.send({"xyz": fr["xyz"], "timestamps": fr["timestamps"],
                    "frame_id": i})
    actor.stop(join=False)
    actor._thread.join(timeout=120)
    assert len(got) == len(frames) and all(s.success for s in got)
    for a, b in zip(actor.odometry.get_trajectory(), direct.get_trajectory()):
        np.testing.assert_array_equal(a.end_pose.tr, b.end_pose.tr)
        np.testing.assert_array_equal(a.end_pose.quat, b.end_pose.quat)
