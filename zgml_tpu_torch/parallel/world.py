"""A world of spawned ranks that run the same functions in step.

JAX runs a multi-device program from one process; the port needs one
process per rank. ``World(n)`` spawns n processes (multiprocessing's spawn
start method: each starts from a fresh import), joins them to one process
group (mesh.init_distributed, init_method file:// under a fresh temporary
directory), and keeps them until ``close``: each
``run(fn, *args)`` hands fn to every rank, which calls fn(device, *args)
with its own device, and returns the ranks' results in rank order. fn and
its arguments are pickled (fn by import path: a module-level function).

Every wait is bounded. A rank that raises fails the run with its
traceback; a rank that does not answer within the run's time limit fails
it with TimeoutError. Either way every rank is killed first (the others
would block in their next collective), so a hung rank costs one run its
limit, never more. ``close`` (and leaving a ``with`` block) joins the
ranks with a time limit and kills the ones still alive.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pathlib
import queue
import tempfile
import time
import traceback

START_TIMEOUT = 300.0     # seconds for every rank to import torch and join the group


def _rank_main(rank: int, n: int, backend: str, init_method: str, device: str, inbox, outbox):
    import torch
    import torch.distributed as dist

    from zgml_tpu_torch.parallel.mesh import init_distributed
    torch.set_num_threads(1)        # n ranks on one host's cores
    try:
        dev = init_distributed(backend, init_method, rank, n, device)
    except BaseException:
        outbox.put((rank, False, traceback.format_exc()))
        raise
    outbox.put((rank, True, str(dev)))
    try:
        while (task := inbox.get()) is not None:
            fn, args, env = task
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                outbox.put((rank, True, fn(dev, *args)))
            except BaseException:          # reported to the parent, which kills the world
                outbox.put((rank, False, traceback.format_exc()))
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
    finally:
        dist.destroy_process_group()


class World:
    """n ranks in one process group over `backend` ("gloo" or "nccl"), each
    on rank_device(device): "cpu", or "cuda" (cuda:(rank % cards))."""

    def __init__(self, n: int, backend: str = "nccl", device: str = "cuda"):
        self.n = n
        self._tmp = tempfile.TemporaryDirectory(prefix="zgml_world_")
        init_method = pathlib.Path(self._tmp.name, "rendezvous").as_uri()
        ctx = mp.get_context("spawn")
        self._outbox = ctx.Queue()
        self._inboxes = [ctx.Queue() for _ in range(n)]
        self._procs = [ctx.Process(target=_rank_main, daemon=True,
                                   args=(r, n, backend, init_method, device,
                                         self._inboxes[r], self._outbox))
                       for r in range(n)]
        for p in self._procs:
            p.start()
        self.devices = self._collect(START_TIMEOUT, "start")

    def _collect(self, timeout: float, what: str) -> list:
        deadline = time.monotonic() + timeout
        got: dict[int, object] = {}
        while len(got) < self.n:
            left = deadline - time.monotonic()
            try:
                rank, ok, value = self._outbox.get(timeout=max(0.01, min(left, 1.0)))
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive() and r not in got]
                if dead or left <= 0:
                    self.kill()
                    why = (f"ranks {dead} exited" if dead else
                           f"ranks {sorted(set(range(self.n)) - set(got))} did not answer "
                           f"within {timeout:g} s")
                    raise TimeoutError(f"world of {self.n}: {what}: {why}") from None
                continue
            if not ok:
                self.kill()
                raise RuntimeError(f"world of {self.n}: {what}: rank {rank} failed:\n{value}")
            got[rank] = value
        return [got[r] for r in range(self.n)]

    def run(self, fn, *args, timeout: float = 120.0, env: dict | None = None) -> list:
        """fn(device, *args) on every rank, under the environment variables
        `env` for its duration; the results in rank order."""
        if not self._procs:
            raise RuntimeError("world is closed")
        for box in self._inboxes:
            box.put((fn, args, dict(env or {})))
        return self._collect(timeout, getattr(fn, "__name__", repr(fn)))

    def kill(self):
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(5)
        self._procs = []
        self._cleanup()

    def close(self, timeout: float = 30.0):
        """Stop the ranks: each leaves its loop and the process group; any
        rank still alive after `timeout` is killed."""
        if not self._procs:
            return
        for box in self._inboxes:
            box.put(None)
        deadline = time.monotonic() + timeout
        for p in self._procs:
            p.join(max(0.0, deadline - time.monotonic()))
        self.kill()

    def _cleanup(self):
        for q in (self._outbox, *self._inboxes):
            q.cancel_join_thread()
            q.close()
        if self._tmp is not None:
            self._tmp.cleanup()
            self._tmp = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
