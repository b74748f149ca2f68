"""The ranks of a run: one process a card.

A cell whose ``chips`` is C runs as a world of C ranks. Rank 0 is the
runner's own process (:func:`ecbench.run.run_cell`); for C > 1 it
builds the program's kernels once and then starts ranks 1 .. C - 1, each
a process of its own (:data:`SERVE`) bound to ``cuda:r``
before any work on the card. Every rank makes its operation with a
:class:`World` (``ops.make(..., world=...)``), which the operation hands
to the program's own ``parallel.init_process_group``: the program picks
its backend as a deployment would.

Rank 0 drives every step (:class:`Ranks`): it sends the step to the other
ranks over the harness's own pipes, runs it itself, and waits for every
reply. The pipes carry the steps, the replies, the slots of the outputs
kept for the judge and the judge's results; the judge's data moves over
a Gloo group of the harness's own (:meth:`World.exchange`). Neither is
the program's process group, so a fault in the program's exchanges never
passes for the harness's.

Every wait has a deadline (:data:`SETUP_LIMIT_S`, :data:`CALL_LIMIT_S`).
A rank that raises, dies or passes a deadline ends the run: every rank is
killed, and rank 0 raises, or, when its own step does not come back from
the program, exits at once (:data:`GRACE_S`). A cell of one chip has no
other ranks: rank 0 runs each step itself and nothing else happens.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from multiprocessing.connection import Connection

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import bench
from . import trace as tr
from .run import Entry, call_busy_s, forbidden_loaded, say

SETUP_LIMIT_S = 300.0   # a step of set-up, the release and the judge
CALL_LIMIT_S = 120.0    # a step of the window; the program's collectives
GRACE_S = 10.0          # for rank 0's own step to fail once the others end
# A rank's process; its standard output is rank 0's standard error.
SERVE = ("import sys; from ecbench.world import _serve; "
         "_serve(int(sys.argv[1]), int(sys.argv[2]))")


@dataclasses.dataclass
class World:
    """What an operation of a multi-card cell is told of its world: this
    rank, the number of ranks, the rendezvous file of the program's
    process group and the timeout of its collectives; and the harness's
    own group, for the judge."""
    rank: int
    size: int
    store: str
    timeout: float
    harness_store: str
    _group: object = dataclasses.field(default=None, repr=False)

    def exchange(self, send):
        """``all_to_all`` on the harness's own Gloo group: ``send[s]`` (a
        [size, ...] tensor) goes to rank s; returns the tensor whose
        ``[s]`` came from rank s, on ``send``'s device. Every rank calls
        it with the same shape. The data travel through the host."""
        import torch.distributed as dist
        if self._group is None:
            store = dist.FileStore(self.harness_store, self.size)
            self._group = dist.ProcessGroupGloo(
                store, self.rank, self.size,
                datetime.timedelta(seconds=SETUP_LIMIT_S))
        host = send.cpu().contiguous()
        recv = torch.empty_like(host)
        self._group.alltoall_base(recv, host, [], []).wait()
        return recv.to(send.device)


def peak_bytes(device) -> int:
    """The most memory the program and the harness held at once on the
    rank's card (0 on the CPU)."""
    if torch.device(device).type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(device)


class Rank:
    """One rank's side of a run: its operation, the outputs it keeps for
    the judge and its profiler. Rank 0 calls these steps itself; the
    other ranks run them as rank 0 sends them (:func:`_serve`)."""

    def __init__(self, cell: bench.Cell, seed: int, device, traced: bool,
                 world: World | None = None):
        from . import ops
        self.device = device
        self.cuda = torch.device(device).type == "cuda"
        self.traced = traced
        self.op = ops.make(cell.config, cell.traffic, seed, device, world)
        self.entry = Entry(self.sync, traced)
        self.kept: list = [None] * cell.traffic["samples"]
        self.activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = self.window = self.trace = None

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def prepare(self) -> None:
        self.op.prepare()
        self.sync()

    def warm(self, i: int) -> None:
        self.op.before(i)
        self.op.call(i, self.entry)
        self.sync()

    def warm_profiler(self, i: int) -> None:
        """A call under a profiler session of its own: the tracer's first
        session can drop kernels, so set-up spends it."""
        with profile(activities=self.activities):
            self.warm(i)

    def before(self, i: int) -> None:
        if self.traced:
            with record_function("ecbench.before"):
                self.op.before(i)
        else:
            self.op.before(i)

    def call(self, i: int, slot) -> list:
        """Call ``i``, fenced on this rank's card; its output kept in
        ``slot`` unless that is None. Returns the entries' host times."""
        self.entry.entries = []
        if self.traced:
            with record_function(tr.CALL):
                out = self.op.call(i, self.entry)
                self.sync()
        else:
            out = self.op.call(i, self.entry)
            self.sync()
        if slot is not None:
            self.kept[slot] = (i, out)
        return self.entry.entries

    def trace_start(self) -> None:
        self.prof = profile(activities=self.activities)
        self.prof.start()

    def trace_window(self) -> None:
        self.window = record_function(tr.WINDOW)
        self.window.__enter__()

    def trace_end(self, names: set):
        """Stops the profiler and reduces its trace (``self.trace``);
        returns the mean device-busy seconds a profiled call, or why the
        trace cannot be read."""
        self.window.__exit__(None, None, None)
        self.prof.stop()
        self.trace = tr.collect(self.prof, names | self.entry.names)
        return self.trace.guard() or call_busy_s(self.trace)

    def peak(self) -> int:
        return peak_bytes(self.device)

    def release(self) -> None:
        """The program's state goes before the reference runs."""
        self.op.release()
        if self.cuda:
            torch.cuda.empty_cache()

    def judge(self):
        """(bad words in each kept output, the calls kept, seconds)."""
        kept = [k for k in self.kept if k is not None]
        t = time.perf_counter()
        bad = self.op.judge(kept)
        return bad, [i for i, _ in kept], time.perf_counter() - t


class _Watch(threading.Thread):
    """Rank 0's watchdog: when another rank ends before it is told to, or
    a step passes its deadline, it kills every other rank; if rank 0's own
    step has not failed GRACE_S later (a collective that waits on a dead
    rank), it ends rank 0's process."""

    def __init__(self, procs: list):
        super().__init__(daemon=True)
        self.procs = procs
        self.step = "start"
        self.deadline = None
        self.reason = None
        self.done = threading.Event()

    def arm(self, step: str, limit: float) -> None:
        self.step, self.deadline = step, time.monotonic() + limit

    def run(self) -> None:
        while not self.done.wait(0.2):
            ended = [(r, p.returncode) for r, p in self.procs
                     if p.poll() is not None]
            if ended:
                self.reason = (f"rank {ended[0][0]} ended with exit code "
                               f"{ended[0][1]} in step {self.step}")
            elif self.deadline is not None and (
                    time.monotonic() > self.deadline):
                self.reason = f"step {self.step} passed its deadline"
            else:
                continue
            if self.done.is_set():      # the ranks were told to stop
                return
            say(f"error: {self.reason}; ending every rank")
            for _, p in self.procs:
                p.kill()
            for _, p in self.procs:
                p.wait()
            if not self.done.wait(GRACE_S):
                say(f"error: rank 0 did not return from step {self.step}; "
                    f"exiting")
                os._exit(4)
            return


class Ranks:
    """Rank 0's handle on the run's ranks: its own :class:`Rank` and, for
    C > 1, the processes of the others. A context manager: on leaving it,
    every other rank has ended and the temporary directory is gone."""

    def __init__(self, cell: bench.Cell, seed: int, device, traced: bool,
                 rank_init=None):
        self.procs: list = []
        self.conns: list = []
        self.watch = None
        self.tmp = None
        size = cell.chips
        if size == 1:
            self.local = Rank(cell, seed, device, traced)
            return
        cuda = torch.device(device).type == "cuda"
        if cuda:
            # one build before any other rank starts: concurrent builds of
            # one directory race
            from fastecc_tpu_torch.kernels import _build
            _build.library()
        self.tmp = tempfile.mkdtemp(prefix="ecbench_world_")
        worlds = [World(r, size, os.path.join(self.tmp, "program"),
                        CALL_LIMIT_S, os.path.join(self.tmp, "harness"))
                  for r in range(size)]
        try:
            for r in range(1, size):
                # a card a rank where there are enough (``main`` asks so)
                dev = (f"cuda:{r % torch.cuda.device_count()}" if cuda
                       else "cpu")
                self._start(r, (r, cell, seed, dev, traced, worlds[r],
                                rank_init))
            self.watch = _Watch(self.procs)
            self.watch.start()
            self.watch.arm("start", SETUP_LIMIT_S)
            self.local = Rank(cell, seed, "cuda:0" if cuda else device,
                              traced, worlds[0])
        except BaseException:
            self.close()
            raise

    def _start(self, rank: int, payload: tuple) -> None:
        ours, theirs = socket.socketpair()
        with theirs:
            proc = subprocess.Popen(
                [sys.executable, "-c", SERVE, str(theirs.fileno()),
                 str(os.getpid())], pass_fds=(theirs.fileno(),),
                cwd=bench.ROOT, stdin=subprocess.DEVNULL, stdout=2)
        self.procs.append((rank, proc))
        conn = Connection(ours.detach())
        self.conns.append(conn)
        conn.send(payload)

    def all(self, step: str, *args, limit: float | None = None) -> list:
        """Runs ``step`` on every rank within ``limit`` seconds (default
        CALL_LIMIT_S); returns each rank's result, rank 0's first, once the
        last has replied."""
        if not self.conns:
            return [getattr(self.local, step)(*args)]
        self.watch.arm(step, CALL_LIMIT_S if limit is None else limit)
        for conn in self.conns:
            conn.send((step, args))
        out = [getattr(self.local, step)(*args)]
        for (rank, _), conn in zip(self.procs, self.conns):
            out.append(self._reply(rank, step, conn))
        self.watch.deadline = None
        return out

    def _reply(self, rank: int, step: str, conn: Connection):
        try:
            kind, value = conn.recv()
        except (EOFError, OSError):
            raise RuntimeError(f"rank {rank} ended in step {step}: "
                               f"{self.watch.reason}") from None
        if kind == "error":
            raise RuntimeError(value)
        return value

    def finish(self) -> None:
        """Stops the other ranks; raises if one loaded a forbidden
        package."""
        if not self.conns:
            return
        self.watch.done.set()
        for conn in self.conns:
            conn.send(("stop", ()))
        loaded = {}
        for (rank, proc), conn in zip(self.procs, self.conns):
            if not conn.poll(CALL_LIMIT_S):
                raise RuntimeError(f"rank {rank} did not stop")
            kind, value = conn.recv()
            if kind == "error" or value:
                loaded[rank] = value
            proc.wait(CALL_LIMIT_S)
        if loaded:
            say(f"error: ranks loaded {loaded}")
            raise RuntimeError(f"ranks loaded forbidden packages: {loaded}")

    def close(self) -> None:
        if self.watch is not None:
            self.watch.done.set()
        for _, proc in self.procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        for conn in self.conns:
            conn.close()
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _die_with_parent(parent: int) -> None:
    """Have the kernel kill this rank when rank 0's process dies."""
    import ctypes
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass                 # not Linux: rank 0 kills the ranks it started
    if os.getppid() != parent:
        os._exit(1)


def _serve(fd: int, parent: int) -> None:
    """A rank other than 0: runs the steps rank 0 sends until "stop"."""
    conn = Connection(fd)
    rank = None
    try:
        _die_with_parent(parent)
        rank, cell, seed, device, traced, world, rank_init = conn.recv()
        if device.startswith("cuda"):
            torch.cuda.set_device(device)
        if rank_init is not None:
            rank_init(rank)
        me = Rank(cell, seed, device, traced, world)
        while True:
            step, args = conn.recv()
            if step == "stop":
                conn.send(("ok", forbidden_loaded()))
                break
            conn.send(("ok", getattr(me, step)(*args)))
    except BaseException as e:
        traceback.print_exc()
        try:
            conn.send(("error", f"rank {rank}: {type(e).__name__}: {e}"))
        except OSError:
            pass
        sys.stderr.flush()
        os._exit(1)
    sys.stderr.flush()
    os._exit(0)
