"""Process 0's teardown of a group run (``launch.leader``), with ``run.drive``
and the peer processes stubbed: it ends its process group before it waits
for a peer (a peer's ``destroy_process_group()`` returns only with process
0's), a peer's non-zero exit still fails the run, and a peer still
running after the grace period is killed."""

import subprocess
import types

import pytest

from benchmark import launch, run

WORLD = 4


class FakePeer:
    """A peer process that exits with ``code`` when waited for, or that
    hangs until it is killed."""

    def __init__(self, order, rank, code=0, hangs=False):
        self.order, self.rank = order, rank
        self.code, self.hangs, self.killed = code, hangs, False

    def _running(self):
        return self.hangs and not self.killed

    def wait(self, timeout=None):
        self.order.append(("wait", self.rank))
        if self._running():
            assert timeout is not None and timeout <= launch.PEER_GRACE_S
            raise subprocess.TimeoutExpired(["peer", str(self.rank)], timeout)
        return self.code

    def poll(self):
        return None if self._running() else self.code

    def kill(self):
        self.order.append(("kill", self.rank))
        self.killed, self.code = True, -9


@pytest.fixture
def group(monkeypatch, tmp_path):
    """Stubs for ``run.Context``, ``run.drive``, ``subprocess.Popen`` and
    ``launch._end_group``; returns (call order, peer factory)."""
    order, made = [], []
    for key in launch._group_env(0, WORLD, ""):
        monkeypatch.setenv(key, "")   # leader() sets them; restored after
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(run, "Context",
                        lambda *a, **kw: types.SimpleNamespace())

    def drive(ctx):
        order.append(("drive", 0))
        return {"attempted": 1}
    monkeypatch.setattr(run, "drive", drive)
    monkeypatch.setattr(launch, "_end_group",
                        lambda: order.append(("end_group", 0)))
    behaviour = {}

    def popen(argv, **kw):
        rank = int(argv[argv.index("--process-id") + 1])
        assert kw["env"]["PROCESS_ID"] == str(rank)
        peer = FakePeer(order, rank, **behaviour.get(rank, {}))
        made.append(peer)
        return peer
    monkeypatch.setattr(launch.subprocess, "Popen", popen)
    return order, behaviour, made


def _leader(tmp_path):
    spec = types.SimpleNamespace(root=str(tmp_path))
    a = types.SimpleNamespace(workload="cell", seed=2 ** 31 + 5, seconds=1.0,
                              trace=0)
    return launch.leader(spec, a, WORLD, t0=0.0)


def test_the_group_ends_before_any_peer_is_waited_for(group, tmp_path):
    order, _, made = group
    out, _ = _leader(tmp_path)
    assert out == {"attempted": 1}
    kinds = [k for k, _ in order]
    assert kinds.index("end_group") < kinds.index("wait")
    assert kinds.index("drive") < kinds.index("end_group")
    assert sorted(r for k, r in order if k == "wait") == [1, 2, 3]
    assert "kill" not in kinds and len(made) == WORLD - 1


def test_a_peer_that_exits_non_zero_fails_the_run(group, tmp_path):
    order, behaviour, _ = group
    behaviour[2] = {"code": 1}
    with pytest.raises(RuntimeError, match="exited with 1"):
        _leader(tmp_path)
    kinds = [k for k, _ in order]
    assert kinds.index("end_group") < kinds.index("wait")


def test_a_peer_still_running_after_the_grace_period_is_killed(group,
                                                               tmp_path):
    order, behaviour, made = group
    behaviour[3] = {"hangs": True}
    with pytest.raises(subprocess.TimeoutExpired):
        _leader(tmp_path)
    assert ("kill", 3) in order
    assert all(p.poll() is not None for p in made)
    kinds = [k for k, _ in order]
    assert kinds.index("end_group") < kinds.index("kill")
