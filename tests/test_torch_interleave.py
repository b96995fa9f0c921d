"""The port's deterministic interleaving harness
(``testing/interleave.py``) against the JAX package's: one seed gives
the same schedule (the same sequence of picks) in both schedulers over
locks, conditions, events, queues and virtual timeouts; deadlocks and
runaway schedules are detected; and the harness drives the port's own
micro-batcher, built inside its window."""

import queue
import threading

import pytest

from photon_ml_tpu.testing import interleave as ref_interleave
from photon_ml_tpu_torch.testing import interleave
from photon_ml_tpu_torch.testing.interleave import (
    InterleaveScheduler,
    StepBudgetExceeded,
    explore,
)


def _mixed_scenario(sched):
    """Locks, a condition, an event, a bounded queue and timed waits
    under the patched primitives; returns the observable log."""
    log = []
    with sched.patched():
        lock = threading.Lock()
        cond = threading.Condition(lock)
        box = []
        q = queue.Queue(maxsize=2)
        done = threading.Event()

        def locker(tag):
            def body():
                for _ in range(3):
                    with lock:
                        log.append(tag)
            return body

        def consumer():
            with lock:
                while not box:
                    cond.wait(timeout=10.0)
                log.append("consumed")

        def producer():
            with lock:
                box.append(1)
                cond.notify()

        def q_worker():
            while True:
                try:
                    item = q.get(timeout=0.25)
                except queue.Empty:
                    if done.is_set():
                        return
                    continue
                log.append(f"q{item}")

        def q_producer():
            for i in range(4):
                q.put(i, timeout=5.0)
            done.set()

        for name, fn in (("a", locker("a")), ("b", locker("b")), ("consumer", consumer),
                         ("producer", producer), ("qw", q_worker), ("qp", q_producer)):
            sched.spawn(fn, name=name)
    return log


@pytest.mark.parametrize("seed", range(6))
def test_same_seed_same_picks_as_the_reference(seed):
    port = InterleaveScheduler(seed=seed)
    port_log = _mixed_scenario(port)
    port.run()
    ref = ref_interleave.InterleaveScheduler(seed=seed)
    ref_log = _mixed_scenario(ref)
    ref.run()
    assert port.trace == ref.trace
    assert port_log == ref_log
    assert port.steps == ref.steps
    assert port.time() == ref.time()


def test_schedules_differ_across_seeds_and_repeat_within_one():
    traces = set()
    for seed in range(8):
        s = InterleaveScheduler(seed=seed)
        _mixed_scenario(s)
        s.run()
        traces.add(tuple(s.trace))
    assert len(traces) > 1
    a, b = InterleaveScheduler(seed=3), InterleaveScheduler(seed=3)
    for s in (a, b):
        _mixed_scenario(s)
        s.run()
    assert a.trace == b.trace


def _inversion(mod, seed):
    s = mod.InterleaveScheduler(seed=seed)
    la, lb = s.Lock(), s.Lock()

    def mk(first, second):
        def body():
            with first:
                with second:
                    pass
        return body

    s.spawn(mk(la, lb), name="t1")
    s.spawn(mk(lb, la), name="t2")
    try:
        s.run()
    except mod.DeadlockError:
        return True
    return False


def test_deadlock_detection_on_the_same_seeds_as_the_reference():
    """A lock-order inversion deadlocks under some schedules: the port
    reports ``DeadlockError`` on exactly the reference's seeds."""
    port = [_inversion(interleave, seed) for seed in range(20)]
    ref = [_inversion(ref_interleave, seed) for seed in range(20)]
    assert port == ref and any(port) and not all(port)


def test_step_budget_stops_a_runaway_schedule():
    s = InterleaveScheduler(seed=0, max_steps=500)
    ev = s.Event()

    def spinner():
        while not ev.is_set():
            ev.wait(timeout=0.001)

    s.spawn(spinner, name="spinner")
    with pytest.raises(StepBudgetExceeded):
        s.run()


def test_explore_names_every_failing_seed():
    def scenario(sched):
        hits = []
        sched.spawn(lambda: hits.append(1), name="w")
        return lambda: (_ for _ in ()).throw(AssertionError("boom"))

    with pytest.raises(AssertionError, match="3/3 schedule"):
        explore(scenario, seeds=range(3))


class _LockProbeMetrics:
    """Records sheds and notes any metrics callback that runs while the
    batcher's Condition-backed queue lock is held by the caller."""

    def __init__(self):
        self.batcher = None
        self.sheds = []
        self.violations = []

    def _held_by_caller(self):
        lock = self.batcher._lock
        owner = getattr(lock, "_owner", None)
        return owner is not None and owner is lock._sched._running

    def record_shed(self, reason):
        if self._held_by_caller():
            self.violations.append(f"record_shed({reason}) under lock")
        self.sheds.append(reason)

    def record_drain(self, report):
        if self._held_by_caller():
            self.violations.append("record_drain under lock")

    def __getattr__(self, name):
        if name.startswith("record_"):
            return lambda *a, **kw: None
        raise AttributeError(name)


def test_drives_the_ports_batcher_shed_and_drain():
    """Submitters flood the port's micro-batcher (built inside the
    window) over a program that pins the dispatcher on the virtual
    clock, and a closer drains it: every submit returns or raises a
    named refusal, no schedule deadlocks, and shed accounting never runs
    under the queue lock."""
    import time

    import numpy as np

    from photon_ml_tpu_torch.serving.admission import ServingError
    from photon_ml_tpu_torch.serving.batcher import MicroBatcher, ScoreRequest

    class SlowPrograms:
        ladder = (1, 2)

        def score(self, bank, batch):
            time.sleep(5.0)  # virtual: pins the dispatcher so the queue fills
            return np.zeros(batch.offsets.shape[0], np.float32)

    class Bank:
        generation = 1
        spec = ("fe",)
        used_shards = ()
        shard_widths = {}
        re_types = ()
        quarantined_re_types = frozenset()
        entity_rows = {}
        retired = False

    total_sheds = []

    def scenario(sched):
        state = {"done": 0}
        with sched.patched():
            metrics = _LockProbeMetrics()
            batcher = MicroBatcher(lambda: Bank(), SlowPrograms(), metrics, max_queue=1)
            metrics.batcher = batcher

            def submitter(uid, deadline):
                def body():
                    try:
                        batcher.submit(ScoreRequest(
                            uid=uid, indices={}, values={}, entity_ids={},
                            deadline_ms=deadline,
                        ))
                    except ServingError:
                        pass  # shed / closed: named outcomes
                    state["done"] += 1
                return body

            def closer():
                time.sleep(30.0)
                batcher.drain(timeout_s=30.0)

            sched.spawn(submitter("a", None), name="sub-a")
            for i in range(3):
                sched.spawn(submitter(f"b{i}", 50.0), name=f"sub-b{i}")
            sched.spawn(closer, name="closer")
            # inside the window: the virtual clock must stay patched
            sched.run()

        def verify():
            assert not metrics.violations, metrics.violations
            assert state["done"] == 4
            total_sheds.extend(metrics.sheds)

        return verify

    explore(scenario, seeds=range(8), max_steps=500_000)
    assert total_sheds, "no schedule shed: the sweep exercised no accounting"


class _FakeGen:
    def __init__(self, generation, parent):
        self.generation = generation
        self.parent = parent
        self.model_dir = f"m{generation}"


class _FakeRegistry:
    root = "<fake>"

    def __init__(self, gens):
        self._gens = {g.generation: g for g in gens}
        self.quarantined = []

    def latest(self):
        live = [g for n, g in self._gens.items() if n not in self.quarantined]
        return max(live, key=lambda g: g.generation) if live else None

    def generation(self, n):
        return self._gens.get(n)

    def lineage(self, n):
        out = []
        while n is not None and n in self._gens:
            out.append(n)
            n = self._gens[n].parent
        return out

    def quarantine_generation(self, n, reason=""):
        self.quarantined.append(n)
        return f"quarantined-{n}"


def test_stale_window_never_rolls_back_twice():
    """``tests/test_interleave.py``'s double-rollback schedule on the
    port's watcher, on the reference's 25 seeds: two feeders keep sending
    unhealthy outcomes against a promoted generation 3 while the watcher
    thread promotes and rolls back (a staging delay opens the preemption
    window), and stragglers arrive after the rollback. Exactly one
    rollback lands, 3 -> 2, and only generation 3 is quarantined: the
    ``_lock`` / ``_swap_serial`` pair keeps a stale window from re-arming
    the trigger."""
    import time

    from photon_ml_tpu_torch.registry.watcher import RegistryWatcher, RollbackPolicy

    class FakeSwapModel:
        def __init__(self):
            self.swaps = []

        def stage_and_swap(self, model_dir, **kw):
            time.sleep(0.2)  # staging takes (virtual) time
            self.swaps.append(model_dir)

            class R:
                ok = True
                error = ""

            return R()

    def scenario(sched):
        state = {}
        with sched.patched():
            registry = _FakeRegistry([_FakeGen(1, None), _FakeGen(2, 1), _FakeGen(3, 2)])
            watcher = RegistryWatcher(
                registry, FakeSwapModel(), poll_s=0.05,
                policy=RollbackPolicy(window=8, min_requests=2, max_unhealthy_rate=0.4),
            )
            state["watcher"], state["registry"] = watcher, registry
            watcher.start()

            def rolled_back():
                return any(r.action == "rollback" for r in watcher.history)

            def feeder():
                for _ in range(300):
                    watcher.observe_outcome(degraded=True)
                    time.sleep(0.01)
                    if rolled_back():
                        break
                for _ in range(5):  # stragglers: the pre-fix re-arm window
                    watcher.observe_outcome(degraded=True)
                    time.sleep(0.01)

            def stopper():
                deadline = time.monotonic() + 60.0
                while time.monotonic() < deadline and not rolled_back():
                    time.sleep(0.05)
                time.sleep(1.0)  # straggler window
                watcher.stop(timeout_s=10.0)

            sched.spawn(feeder, name="feeder-a")
            sched.spawn(feeder, name="feeder-b")
            sched.spawn(stopper, name="stopper")
            sched.run()

        def verify():
            watcher, registry = state["watcher"], state["registry"]
            rollbacks = [r for r in watcher.history if r.action == "rollback"]
            assert len(rollbacks) == 1, [(r.action, r.registry_generation) for r in watcher.history]
            assert rollbacks[0].registry_generation == 2
            assert registry.quarantined == [3], registry.quarantined

        return verify

    explore(scenario, seeds=range(25))
