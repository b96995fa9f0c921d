"""Deterministic interleaving harness: a seeded cooperative scheduler
for the serving thread plane (a copy of
``photon_ml_tpu/testing/interleave.py``, which imports nothing of JAX).

Stress runs can only sample schedules the OS happens to produce; this harness OWNS the
schedule: it wraps the ``threading`` primitives (Lock, RLock,
Condition, Event, Thread) with cooperative versions that hand control
to a scheduler at every acquisition, wait, notify and spawn — the
deterministic preemption points — and the scheduler picks the next
runnable thread with a seeded RNG. Same seed, same schedule, every
run: a race found once is a regression test forever, and ``explore``
sweeps a seed set so tests can demand "zero invariant violations over
N schedules of submit/close/swap/rollback".

Time is VIRTUAL (discrete-event): a timed wait registers a deadline on
the logical clock, and the clock only advances when every live thread
is blocked — jumping straight to the earliest deadline. Patching
``time.monotonic``/``time.perf_counter`` onto the logical clock makes
production deadline math (submit budgets, heartbeat beats, queue
polls) deterministic too. A schedule where every thread is blocked
with no deadline is reported as :class:`DeadlockError`.

Usage::

    sched = InterleaveScheduler(seed=7)
    with sched.patched():          # threading.* / time.* -> cooperative
        batcher = MicroBatcher(...)   # constructed INSIDE the window
        sched.spawn(lambda: batcher.submit(req), name="client")
        sched.spawn(batcher.close, name="closer")
    sched.run()                    # drives to completion, one schedule

Only code that parks on the managed primitives is schedulable; a
managed thread blocking on a REAL socket/file would stall the harness,
so tests drive fakes (``tests/test_torch_interleave.py``).
"""

from __future__ import annotations

import queue as _queue
import random
import threading as _threading
import time as _time
from collections import deque
from contextlib import contextmanager
from typing import Callable, List, Optional, Sequence

__all__ = [
    "DeadlockError",
    "StepBudgetExceeded",
    "InterleaveScheduler",
    "explore",
]

# the raw C-level thread API: the harness's own machinery must not run
# through ``threading.Thread``/``threading.Event``, whose constructors
# resolve the (patched) module globals at call time
import _thread as _raw_thread  # noqa: E402


class _RawGate:
    """Binary handshake gate built directly on the C lock primitive —
    ``threading.Event`` internally calls ``threading.Condition`` at
    CONSTRUCTION time, which would recurse into the patched
    cooperative primitives; the raw lock cannot be patched. ``set``
    releases, ``wait`` acquires (auto-consuming), which is exactly the
    alternating scheduler<->thread lockstep."""

    def __init__(self):
        self._lock = _raw_thread.allocate_lock()
        self._lock.acquire()  # starts "unset"

    def set(self) -> None:
        try:
            self._lock.release()
        except RuntimeError:
            pass  # already set

    def wait(self) -> None:
        self._lock.acquire()


class DeadlockError(AssertionError):
    """Every live thread is blocked and no deadline can unblock one."""


class StepBudgetExceeded(AssertionError):
    """The schedule exceeded max_steps — a livelock or runaway loop."""


class _Task:
    """One managed thread: a real OS thread in lockstep with the
    scheduler (at most one unparked at any instant)."""

    def __init__(self, sched: "InterleaveScheduler", fn: Callable,
                 name: str):
        self.sched = sched
        self.fn = fn
        self.name = name
        self.go = _RawGate()
        self.parked = _RawGate()
        self.started = False
        # single-writer atomic publishes: only the task's own OS
        # thread writes them (plain assignments in _run), the
        # scheduler reads them — the discipline the serving plane
        # declares the same way
        self.finished = False  # photon: guarded-by(atomic)
        self.error: Optional[BaseException] = None  # photon: guarded-by(atomic)
        # block state, read by the scheduler to compute runnability
        self.block_pred: Optional[Callable[[], bool]] = None
        self.deadline: Optional[float] = None

    def start_os_thread(self) -> None:
        # raw spawn: threading.Thread would build its _started Event
        # through the patched module globals
        _raw_thread.start_new_thread(self._run, ())

    def _run(self) -> None:
        self.go.wait()
        try:
            self.fn()
        except BaseException as e:  # surfaced by run()
            self.error = e
        finally:
            self.finished = True
            self.parked.set()

    def runnable(self, now: float) -> bool:
        if self.finished:
            return False
        if self.block_pred is None:
            return True
        if self.block_pred():
            return True
        return self.deadline is not None and now >= self.deadline


class _CoopLock:
    """Cooperative Lock/RLock. State is plain Python — safe because the
    scheduler never lets two managed threads run at once."""

    def __init__(self, sched: "InterleaveScheduler",
                 reentrant: bool = False):
        self._sched = sched
        self._reentrant = reentrant
        self._owner: Optional[_Task] = None
        self._count = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        sched = self._sched
        t = sched._current()
        sched._preempt()  # schedules may interleave JUST before entry
        if self._owner is t and self._reentrant:
            self._count += 1
            return True
        if self._owner is t and not self._reentrant:
            if not blocking:
                return False  # real Lock semantics: try-acquire fails
            raise RuntimeError(
                f"non-reentrant lock re-acquired by {t.name} — "
                "a guaranteed self-deadlock"
            )
        if self._owner is None:
            self._owner = t
            self._count = 1
            return True
        if not blocking:
            return False
        deadline = (
            None if timeout is None or timeout < 0
            else sched.time() + timeout
        )
        ok = sched._block(lambda: self._owner is None, deadline)
        if not ok:
            return False
        self._owner = t
        self._count = 1
        return True

    def release(self) -> None:
        t = self._sched._current()
        if self._owner is not t:
            raise RuntimeError(f"release of un-owned lock by {t.name}")
        self._count -= 1
        if self._count == 0:
            self._owner = None
            self._sched._preempt()

    def locked(self) -> bool:
        return self._owner is not None

    # release EVERYTHING (Condition.wait on an RLock) and restore
    def _release_save(self):
        owner, count = self._owner, self._count
        self._owner, self._count = None, 0
        return owner, count

    def _acquire_restore(self, state) -> None:
        owner, count = state
        self._sched._block(lambda: self._owner is None, None)
        self._owner, self._count = owner, count

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class _CoopCondition:
    def __init__(self, sched: "InterleaveScheduler", lock=None):
        self._sched = sched
        self._lock = lock if lock is not None else _CoopLock(sched)
        self._notified: set = set()
        self._waiters: List[_Task] = []

    def acquire(self, *a, **kw):
        return self._lock.acquire(*a, **kw)

    def release(self):
        return self._lock.release()

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False

    def wait(self, timeout: Optional[float] = None) -> bool:
        sched = self._sched
        t = sched._current()
        if self._lock._owner is not t:
            raise RuntimeError("cannot wait on un-acquired condition")
        deadline = (
            None if timeout is None else sched.time() + float(timeout)
        )
        self._waiters.append(t)
        state = self._lock._release_save()
        sched._block(lambda: t in self._notified, deadline)
        notified = t in self._notified
        self._notified.discard(t)
        if t in self._waiters:
            self._waiters.remove(t)
        self._lock._acquire_restore(state)
        return notified

    def wait_for(self, predicate, timeout: Optional[float] = None):
        sched = self._sched
        endtime = (
            None if timeout is None else sched.time() + float(timeout)
        )
        result = predicate()
        while not result:
            if endtime is not None:
                waittime = endtime - sched.time()
                if waittime <= 0:
                    break
                self.wait(waittime)
            else:
                self.wait(None)
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        if self._lock._owner is not self._sched._current():
            raise RuntimeError("cannot notify on un-acquired condition")
        for t in self._waiters[:n]:
            self._notified.add(t)
        self._sched._preempt()

    def notify_all(self) -> None:
        self.notify(len(self._waiters))


class _CoopEvent:
    def __init__(self, sched: "InterleaveScheduler"):
        self._sched = sched
        self._flag = False

    def is_set(self) -> bool:
        return self._flag

    def set(self) -> None:
        self._flag = True
        self._sched._preempt()

    def clear(self) -> None:
        self._flag = False

    def wait(self, timeout: Optional[float] = None) -> bool:
        sched = self._sched
        if self._flag:
            sched._preempt()
            return True
        deadline = (
            None if timeout is None else sched.time() + float(timeout)
        )
        sched._block(lambda: self._flag, deadline)
        return self._flag


class _CoopQueue:
    """queue.Queue stand-in on the virtual clock (the stdlib Queue
    binds ``time.monotonic`` at import, so its timeouts would burn real
    time under the scheduler). Raises the REAL queue.Full/queue.Empty
    so production except-clauses keep working."""

    def __init__(self, sched: "InterleaveScheduler", maxsize: int = 0):
        self._sched = sched
        self.maxsize = int(maxsize)
        self._items: deque = deque()

    def qsize(self) -> int:
        return len(self._items)

    def empty(self) -> bool:
        return not self._items

    def full(self) -> bool:
        return 0 < self.maxsize <= len(self._items)

    def put_nowait(self, item) -> None:
        if self.full():
            raise _queue.Full
        self._items.append(item)
        self._sched._preempt()

    def get_nowait(self):
        if not self._items:
            raise _queue.Empty
        item = self._items.popleft()
        self._sched._preempt()
        return item

    def put(self, item, block: bool = True,
            timeout: Optional[float] = None) -> None:
        if not block:
            return self.put_nowait(item)
        deadline = (
            None if timeout is None
            else self._sched.time() + float(timeout)
        )
        ok = self._sched._block(lambda: not self.full(), deadline)
        if not ok:
            raise _queue.Full
        self._items.append(item)

    def get(self, block: bool = True, timeout: Optional[float] = None):
        if not block:
            return self.get_nowait()
        deadline = (
            None if timeout is None
            else self._sched.time() + float(timeout)
        )
        ok = self._sched._block(lambda: bool(self._items), deadline)
        if not ok:
            raise _queue.Empty
        return self._items.popleft()


class _CoopThread:
    """threading.Thread stand-in registering with the scheduler."""

    _counter = 0

    def __init__(self, group=None, target=None, name=None, args=(),
                 kwargs=None, *, daemon=None, sched=None):
        _CoopThread._counter += 1
        self._sched = sched
        self._target = target
        self._args = args
        self._kwargs = kwargs or {}
        self.name = name or f"coop-{_CoopThread._counter}"
        self.daemon = bool(daemon) if daemon is not None else True
        self._task: Optional[_Task] = None

    def start(self) -> None:
        if self._task is not None:
            raise RuntimeError("threads can only be started once")

        def body():
            if self._target is not None:
                self._target(*self._args, **self._kwargs)

        self._task = self._sched.spawn(body, name=self.name)

    def join(self, timeout: Optional[float] = None) -> None:
        task = self._task
        if task is None:
            raise RuntimeError("cannot join un-started thread")
        deadline = (
            None
            if timeout is None
            else self._sched.time() + float(timeout)
        )
        self._sched._block(lambda: task.finished, deadline)

    def is_alive(self) -> bool:
        return self._task is not None and not self._task.finished


class InterleaveScheduler:
    """The seeded cooperative scheduler. One instance = one replayable
    schedule universe; ``seed`` fully determines every pick."""

    def __init__(self, seed: int = 0, max_steps: int = 200_000,
                 tick_quantum: float = 0.05):
        self.seed = int(seed)
        self.rng = random.Random(self.seed)
        self.max_steps = int(max_steps)
        # bound on how far ONE scheduled <tick> may advance the clock:
        # timeouts race runnable threads (that is the point of the
        # tick), but an unbounded jump to some far-future deadline
        # would warp past every intermediate moment a runnable thread
        # was about to create (its next sleep/wait deadline), gutting
        # the scenario's relative timing
        self.tick_quantum = float(tick_quantum)
        self.steps = 0
        self._now = 1000.0  # virtual; arbitrary epoch
        self._tasks: List[_Task] = []
        self._running: Optional[_Task] = None
        self._started = False
        self.trace: List[str] = []  # thread names, in schedule order
        # pseudo-task identity for UNMANAGED callers (construction-time
        # code on the test's own thread, e.g. Future.set_result inside
        # the patch window): they may own cooperative locks but never
        # park — their blocking resolves immediately against current
        # state (construction is single-threaded by contract)
        self._main = _Task(self, lambda: None, "<main>")

    # -- public surface ------------------------------------------------------

    def time(self) -> float:
        return self._now

    def sleep(self, seconds: float) -> None:
        deadline = self._now + max(float(seconds), 0.0)
        self._block(lambda: False, deadline)

    def spawn(self, fn: Callable, name: Optional[str] = None) -> _Task:
        task = _Task(self, fn, name or f"task-{len(self._tasks)}")
        self._tasks.append(task)
        task.start_os_thread()
        task.started = True
        return task

    def Lock(self) -> _CoopLock:
        return _CoopLock(self)

    def RLock(self) -> _CoopLock:
        return _CoopLock(self, reentrant=True)

    def Condition(self, lock=None) -> _CoopCondition:
        return _CoopCondition(self, lock)

    def Event(self) -> _CoopEvent:
        return _CoopEvent(self)

    def Thread(self, *a, **kw) -> _CoopThread:
        return _CoopThread(*a, sched=self, **kw)

    def Queue(self, maxsize: int = 0) -> _CoopQueue:
        return _CoopQueue(self, maxsize)

    @contextmanager
    def patched(self):
        """Swap ``threading``/``time`` module attributes for the
        cooperative versions, so production classes CONSTRUCTED inside
        the window (and the stdlib ``queue`` built on them) run on this
        scheduler. Construction only registers state — drive the
        schedule with :meth:`run` after the window closes (or inside;
        both work, patches are restored either way)."""
        saved = {
            "Lock": _threading.Lock,
            "RLock": _threading.RLock,
            "Condition": _threading.Condition,
            "Event": _threading.Event,
            "Thread": _threading.Thread,
        }
        saved_time = {
            "monotonic": _time.monotonic,
            "perf_counter": _time.perf_counter,
            "sleep": _time.sleep,
        }
        saved_queue = _queue.Queue
        _threading.Lock = self.Lock
        _threading.RLock = self.RLock
        _threading.Condition = self.Condition
        _threading.Event = self.Event
        _threading.Thread = self.Thread
        _time.monotonic = self.time
        _time.perf_counter = self.time
        _time.sleep = self.sleep
        _queue.Queue = self.Queue
        try:
            yield self
        finally:
            for k, v in saved.items():
                setattr(_threading, k, v)
            for k, v in saved_time.items():
                setattr(_time, k, v)
            _queue.Queue = saved_queue

    def run(self, until: Optional[Callable[[], bool]] = None) -> None:
        """Drive the schedule until every task finishes (or ``until``
        returns True). Raises the first task exception, DeadlockError
        when no task can ever run again, StepBudgetExceeded past the
        step budget."""
        self._started = True
        while True:
            live = [t for t in self._tasks if not t.finished]
            if not live:
                break
            if until is not None and until():
                break
            runnable = [t for t in live if t.runnable(self._now)]
            # deadlines of threads that are NOT yet runnable: firing a
            # timeout is itself a schedulable event — real timeouts
            # race running threads, so the virtual clock may jump even
            # while work is runnable (this is what makes e.g. a poll
            # loop's drain check interleave into another thread's
            # two-step update)
            pending_deadlines = [
                t.deadline for t in live
                if t.deadline is not None and not t.runnable(self._now)
            ]
            if not runnable:
                if not pending_deadlines:
                    blocked = ", ".join(t.name for t in live)
                    raise DeadlockError(
                        f"seed {self.seed}: all threads blocked with no "
                        f"deadline — deadlock among [{blocked}] after "
                        f"{self.steps} step(s); trace tail: "
                        f"{self.trace[-12:]}"
                    )
                self._now = min(pending_deadlines)
                continue
            self.steps += 1
            if self.steps > self.max_steps:
                raise StepBudgetExceeded(
                    f"seed {self.seed}: {self.steps} scheduler steps "
                    "without completion — livelock or runaway loop; "
                    f"trace tail: {self.trace[-12:]}"
                )
            choices: List = sorted(runnable, key=lambda t: t.name)
            if pending_deadlines:
                choices.append(None)  # None = fire the next timeout
            task = self.rng.choice(choices)
            if task is None:
                # advance toward (at most quantum; exactly onto when
                # imminent) the earliest pending deadline
                self._now = min(
                    self._now + self.tick_quantum,
                    min(pending_deadlines),
                )
                self.trace.append("<tick>")
                continue
            self.trace.append(task.name)
            self._resume(task)
        for t in self._tasks:
            if t.error is not None:
                raise t.error

    # -- scheduler internals -------------------------------------------------

    def _current(self) -> _Task:
        cur = self._running
        if cur is None:
            return self._main  # unmanaged (construction-time) caller
        return cur

    def _resume(self, task: _Task) -> None:
        task.block_pred = None
        task.deadline = None
        self._running = task
        task.go.set()
        task.parked.wait()  # auto-consumes: gate is reset by the wait
        self._running = None

    def _park(self, task: _Task) -> None:
        """Called ON the task's thread: hand control back, wait to be
        rescheduled."""
        task.parked.set()
        task.go.wait()  # auto-consumes

    def _preempt(self) -> None:
        """A deterministic preemption point: the running thread offers
        the scheduler a chance to run someone else."""
        task = self._running
        if task is None:
            return  # outside a managed thread (construction time)
        self._park(task)

    def _block(self, predicate: Callable[[], bool],
               deadline: Optional[float]) -> bool:
        """Park until ``predicate()`` or the virtual deadline. Returns
        the predicate's final verdict (False = timed out)."""
        task = self._running
        if task is None:
            # construction-time call (e.g. Event.wait before run());
            # resolve immediately against current state
            return bool(predicate())
        while True:
            if predicate():
                return True
            if deadline is not None and self._now >= deadline:
                return False
            task.block_pred = predicate
            task.deadline = deadline
            self._park(task)
            task.block_pred = None
            task.deadline = None


def explore(
    scenario: Callable[[InterleaveScheduler], Optional[Callable]],
    seeds: Sequence[int] = range(20),
    max_steps: int = 200_000,
) -> List[int]:
    """Run ``scenario`` once per seed. The scenario receives a fresh
    scheduler, builds its world (typically inside ``sched.patched()``),
    spawns threads, and may return a verifier callable that runs after
    the schedule completes. Returns the list of seeds driven; raises
    AssertionError naming every failing seed (each independently
    replayable)."""
    failures: List[str] = []
    for seed in seeds:
        sched = InterleaveScheduler(seed=seed, max_steps=max_steps)
        try:
            verify = scenario(sched)
            sched.run()
            if verify is not None:
                verify()
        except BaseException as e:
            failures.append(f"seed {seed}: {type(e).__name__}: {e}")
    if failures:
        raise AssertionError(
            f"{len(failures)}/{len(list(seeds))} schedule(s) violated "
            "invariants:\n" + "\n".join(failures[:10])
        )
    return list(seeds)
