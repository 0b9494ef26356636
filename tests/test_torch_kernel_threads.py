"""The moment-curve launchers' shared state under threads.

The online engine launches the kernels from several threads (its pump or
deadline thread and the caller that ticks). The aggregate kernel keeps one
grid-barrier slot a stream, handed out by ``kernel._barrier_slot``, and the
library is built and declared once by ``kernel._library``. Both are
guarded by one lock; these tests race many threads through each, with a
fake library (the CPU has no card), a switch interval of 10 µs and a
sleep inside the guarded section that widens any window for a lost update.
"""
import sys
import threading
import time

import pytest

from repro_torch.kernels.moment_curves import kernel as K

N_THREADS = 48
TIMEOUT = 60.0


class _FakeLibrary:
    def __init__(self, slots):
        self.slots = slots

    def mc_barrier_slots(self):
        time.sleep(1e-4)          # a lost update needs a switch in here
        return self.slots


def _race(target, n_threads=N_THREADS):
    errors = []

    def run(i):
        try:
            target(i)
        except Exception as exc:      # pragma: no cover - reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


@pytest.mark.parametrize("n_streams", [3, 8])
def test_barrier_slots_are_distinct_under_threads(monkeypatch, n_streams):
    monkeypatch.setattr(K, "_BARRIER_SLOTS", {})
    monkeypatch.setattr(K, "_library", lambda: _FakeLibrary(64))
    got = {}
    lock = threading.Lock()

    def ask(i):
        stream = 0x7F00 + (i % n_streams)
        for device in (0, 1):
            slot = K._barrier_slot(device, stream)
            with lock:
                got.setdefault((device, stream), set()).add(slot)

    _race(ask)
    for device in (0, 1):
        slots = [got[(device, 0x7F00 + s)] for s in range(n_streams)]
        assert all(len(s) == 1 for s in slots), slots   # one slot a stream
        assert sorted(x for s in slots for x in s) == list(range(n_streams))


def test_barrier_slots_run_out_and_raise(monkeypatch):
    monkeypatch.setattr(K, "_BARRIER_SLOTS", {})
    monkeypatch.setattr(K, "_library", lambda: _FakeLibrary(4))

    def ask(i):
        if i < 4:
            K._barrier_slot(0, 100 + i)

    _race(ask, n_threads=8)
    assert sorted(K._BARRIER_SLOTS.values()) == [0, 1, 2, 3]
    with pytest.raises(RuntimeError, match="all are taken"):
        K._barrier_slot(0, 999)
    assert K._barrier_slot(1, 999) == 0       # another device's slots


def test_library_is_built_one_thread_at_a_time(monkeypatch):
    inside, most, builds = [0], [0], []
    lock = threading.Lock()
    lib = object()

    def fake_load(source):
        with lock:
            inside[0] += 1
            most[0] = max(most[0], inside[0])
        time.sleep(1e-3)
        with lock:
            inside[0] -= 1
            builds.append(source)
        return lib

    monkeypatch.setattr(K, "load_library", fake_load)
    monkeypatch.setattr(K, "_declare", lambda x: x)
    K._library.cache_clear()
    try:
        seen = []
        _race(lambda i: seen.append(K._library()))
    finally:
        K._library.cache_clear()
    assert most[0] == 1
    assert builds and all(s == K.SOURCE for s in builds)
    assert all(x is lib for x in seen) and len(seen) == N_THREADS
