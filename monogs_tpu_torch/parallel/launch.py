"""The ranks of a sharded mapping run, brought up from one process.

The JAX package runs one controller over every device; the port runs one
process per rank. ``RankGroup`` makes them: this process is rank 0 (the
SLAM process; its backend thread issues every sharded call) and ranks
1..D-1 are worker processes started with ``torch.multiprocessing``'s
"spawn" context, which run ``_worker``.

- **Rendezvous.** Rank 0 binds a ``TCPStore`` on localhost to port 0 (a
  free port: a fixed ``MASTER_PORT`` would collide between runs that
  overlap, such as parallel test workers) and hands the bound port to the
  workers; every rank joins the default process group through that store,
  with an explicit timeout (``timeout_s``), and builds its meshes there.
- **Device per rank.** With NCCL rank r runs on ``cuda:r``; a group of
  more ranks than ``torch.cuda.device_count()`` raises and names both
  counts (``check_devices``). With gloo every rank runs on rank 0's
  device: the CPU, or one card that all ranks share, the counterpart of
  the JAX package's virtual devices.
- **Calls.** Rank 0 writes each call's header (what to run, with which
  mesh shape and static arguments) under a key of the store; a worker
  waits on the store between calls, not in a collective, so that however
  long rank 0 tracks between two mapping calls no collective times out.
  Then the call's tensors follow by broadcast (``map_iters``: the map, the
  views and the window Adam state, on each rank's own device) or pickled
  (``call``), and every rank of the mesh runs the same function; ranks
  outside a smaller mesh skip the call. Each rank builds a mesh shape once
  (``DeviceMesh`` needs every rank of the default group).
- **Builds.** The list kernels' library (kernels #2 and #6, all that the
  sharded loops launch) is built in rank 0 before the workers start
  (``_build.build_all``), so that D compilers do not race; the workers
  load what rank 0 built.
- **Failure.** A worker that raises writes its traceback to the store and
  exits; its exit fails rank 0's next collective (gloo), or that
  collective times out (NCCL, after the group's timeout). Rank 0 then
  raises ``RuntimeError`` with the worker's traceback as its cause
  (``WorkerError``). ``stop`` ends the workers (a stop call, then
  terminate and kill for any still alive) and leaves no live child; a
  worker whose rank 0 has gone exits by itself.
"""

from __future__ import annotations

import datetime
import os
import pickle
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from . import comm

DEFAULT_TIMEOUT_S = 600.0
_HOST = "127.0.0.1"


class WorkerError(RuntimeError):
    """A worker rank's exception: its traceback, as text."""


def check_devices(n_ranks: int, backend: str, device) -> None:
    """Raise for a group that ``backend`` cannot place on this machine."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"dist_backend={backend!r}: expected 'nccl' or "
                         "'gloo'")
    if backend == "nccl":
        if torch.device(device).type != "cuda":
            raise ValueError("dist_backend='nccl' needs a CUDA device; gloo "
                             "runs the ranks on the CPU")
        n = torch.cuda.device_count()
        if n < n_ranks:
            raise RuntimeError(
                f"{n_ranks} ranks on NCCL need a card each, but this machine "
                f"has {n} card{'s' if n != 1 else ''} "
                "(torch.cuda.device_count()); dist_backend='gloo' shares "
                "one card among the ranks")


def rank_device(rank: int, backend: str, device) -> torch.device:
    """The device of ``rank``: ``cuda:rank`` for NCCL, else rank 0's (a
    bare "cuda" is the current card)."""
    if backend == "nccl":
        return torch.device("cuda", rank)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def build_mesh(shape):
    """The mesh of a (n_view, n_gauss) shape over the first ranks: "view"
    alone, "gauss" alone, or ("view", "gauss")."""
    from .gauss import make_gauss_mesh
    from .gauss_iters import make_gauss_mesh2
    from .mesh import make_mesh

    n_view, n_gauss = shape
    if n_gauss == 1:
        return make_mesh(n_view)
    if n_view == 1:
        return make_gauss_mesh(n_gauss)
    return make_gauss_mesh2(n_view, n_gauss)


def sharded_map_iters(mesh, shape, m, cams, n_iters, it_count, generator,
                      intr, cfg, mcfg, hyper, kf_adam=None,
                      initialization=False, draws=None):
    """The sharded loop of a mesh shape: the map sharded over "gauss" when
    there is such a dimension (``gp_sharded_map_iters``), else the views
    over "view" (``mesh.sharded_map_iters``); the JAX backend's routing."""
    from .gauss_iters import gp_sharded_map_iters
    from .mesh import sharded_map_iters as view_map_iters

    fn = gp_sharded_map_iters if shape[1] > 1 else view_map_iters
    return fn(m, cams, n_iters, it_count, generator, mesh, intr, cfg, mcfg,
              hyper, kf_adam=kf_adam, initialization=initialization,
              draws=draws)


def _map_tensors(m, cams, kf_adam) -> list:
    out = [*m.params, *m.adam_m, *m.adam_v, *m[3:], *cams]
    return out + list(kf_adam[:2]) if kf_adam is not None else out


def _from_tensors(ts: list, kat):
    from ..models import gaussian_map as gm
    from ..slam.mapping import CamBatch

    m = gm.GaussianMap(gm.ParamLeaves(*ts[:5]), gm.ParamLeaves(*ts[5:10]),
                       gm.ParamLeaves(*ts[10:15]), *ts[15:22])
    cams = CamBatch(*ts[22:31])
    return m, cams, (ts[31], ts[32], kat) if len(ts) > 31 else None


def _to_device(x, dev):
    if torch.is_tensor(x):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_device(y, dev) for y in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_device(y, dev) for y in x)
    if isinstance(x, dict):
        return {k: _to_device(v, dev) for k, v in x.items()}
    return x


def _to_cpu(x):
    return _to_device(x, torch.device("cpu"))


def _on_card() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def report(mesh):
    """This rank's kernel launches and peak memory on its current card
    (``RankGroup.launches``)."""
    from ..utils.roofline import all_launches

    return dict(rank=dist.get_rank(), launches=all_launches(),
                max_memory_allocated=(torch.cuda.max_memory_allocated()
                                      if _on_card() else None))


def reset(mesh):
    """Zero this rank's launch counters and its peak memory statistic."""
    from ..utils.roofline import launch_counters

    for c in launch_counters():
        for k in c:
            c[k] = 0
    if _on_card():
        torch.cuda.reset_peak_memory_stats()


class _Ranks:
    """What every rank keeps: its store, device, generator and meshes."""

    def __init__(self, store, rank: int, world: int, device):
        self.store, self.rank, self.world = store, rank, world
        self.device = device
        self.meshes = {}
        self.generator = torch.Generator(device=device)

    def mesh(self, shape):
        shape = tuple(shape)
        if shape not in self.meshes:
            self.meshes[shape] = build_mesh(shape)
        return self.meshes[shape]

    def run(self, hdr, payload):
        """Run one call's body on this rank; None where the rank is
        outside the call's mesh."""
        shape = hdr["shape"]
        mesh = self.mesh(shape)
        if self.rank >= shape[0] * shape[1]:
            return None
        if hdr["op"] == "map":
            m, cams, ka = payload
            return sharded_map_iters(
                mesh, shape, m, cams, hdr["n_iters"], hdr["it_count"],
                self.generator if hdr["generator"] else None, hdr["intr"],
                hdr["cfg"], hdr["mcfg"], hdr["hyper"], kf_adam=ka,
                initialization=hdr["initialization"], draws=None)
        fn, args = payload
        return fn(mesh, *args)

    def receive(self, hdr):
        """The call's payload on a worker."""
        if hdr["op"] == "map":
            ts = comm.broadcast_many(
                [torch.empty(s, dtype=d, device=self.device)
                 for s, d in hdr["specs"]], dist.group.WORLD)
            return _from_tensors(ts, hdr["kat"])
        box = [None]
        dist.broadcast_object_list(box, 0, device=_object_device(
            self.device))
        return _to_device(box[0], self.device)


def _object_device(device):
    return device if dist.get_backend() == "nccl" else torch.device("cpu")


def _worker(rank: int, world: int, port: int, backend: str, device: str,
            timeout_s: float, threads: int, parent: int):
    """A worker rank: join the group, then run rank 0's calls until told
    to stop or until rank 0 is gone."""
    store = None
    try:
        torch.set_num_threads(threads)
        timeout = datetime.timedelta(seconds=timeout_s)
        dev = rank_device(rank, backend, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.TCPStore(_HOST, port, world, False, timeout=timeout)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world, timeout=timeout)
        ranks = _Ranks(store, rank, world, dev)
        seq = 0
        while True:
            seq += 1
            key, nap = f"call/{seq}", 0.001
            while not store.check([key]):
                if os.getppid() != parent:
                    return              # rank 0 has gone
                time.sleep(nap)
                nap = min(2 * nap, 0.02)
            hdr = pickle.loads(store.get(key))
            if hdr["op"] == "stop":
                break
            out = ranks.run(hdr, ranks.receive(hdr))
            if hdr.get("reply") and out is not None:
                store.set(f"reply/{seq}/{rank}", pickle.dumps(_to_cpu(out)))
        dist.destroy_process_group()
    except BaseException:
        if store is not None:
            try:
                store.set(f"error/{rank}", traceback.format_exc())
            except RuntimeError:
                pass            # rank 0 and its store have gone
        os._exit(1)


class RankGroup:
    """``n_ranks`` ranks: this process (rank 0) and ``n_ranks - 1`` workers
    (module docstring). ``start`` brings them up, ``map_iters`` and
    ``call`` run SPMD calls, ``launches`` reads every rank's kernel
    counters, ``stop`` ends them; also a context manager."""

    def __init__(self, n_ranks: int, backend: str, device,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        check_devices(n_ranks, backend, device)
        self.n_ranks, self.backend = n_ranks, backend
        self.device = rank_device(0, backend, device)
        self.timeout = datetime.timedelta(seconds=timeout_s)
        self.procs = []
        self.store = None
        self._ranks: Optional[_Ranks] = None
        self._seq = 0
        self._failed = False
        # every rank's ``launches()`` as ``stop`` found them
        self.final_launches: Optional[list] = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def start(self) -> "RankGroup":
        if dist.is_initialized():
            raise RuntimeError("a default process group is already "
                               "initialised in this process")
        if self.device.type == "cuda":
            from .._build import build_all

            torch.cuda.set_device(self.device)
            build_all(["blend_lists"])
        self.store = dist.TCPStore(_HOST, 0, self.n_ranks, True,
                                   timeout=self.timeout,
                                   wait_for_workers=False)
        ctx = torch.multiprocessing.get_context("spawn")
        try:
            for r in range(1, self.n_ranks):
                p = ctx.Process(
                    target=_worker, name=f"monogs-rank{r}", daemon=True,
                    args=(r, self.n_ranks, self.store.port, self.backend,
                          str(self.device), self.timeout.total_seconds(),
                          torch.get_num_threads(), os.getpid()))
                p.start()
                self.procs.append(p)
            dist.init_process_group(self.backend, store=self.store, rank=0,
                                    world_size=self.n_ranks,
                                    timeout=self.timeout)
            self._ranks = _Ranks(self.store, 0, self.n_ranks, self.device)
        except BaseException as e:
            err = self._failure(e)
            self.stop()
            raise err from (e if err is not e else None)
        return self

    def _post(self, hdr: dict) -> int:
        self._seq += 1
        self.store.set(f"call/{self._seq}", pickle.dumps(hdr))
        return self._seq

    def _failure(self, e: BaseException) -> BaseException:
        """The worker's error behind ``e`` (raised on rank 0), if a worker
        failed; it writes its traceback before it exits."""
        if self.store is None:
            return e
        deadline = time.monotonic() + 10.0
        while True:
            for r in range(1, self.n_ranks):
                if self.store.check([f"error/{r}"]):
                    err = RuntimeError(f"sharded mapping failed on rank {r}")
                    err.__cause__ = WorkerError(
                        self.store.get(f"error/{r}").decode())
                    return err
            if (time.monotonic() > deadline
                    or all(p.is_alive() for p in self.procs)):
                return e
            time.sleep(0.05)

    def _guarded(self, fn):
        try:
            return fn()
        except Exception as e:
            self._failed = True
            err = self._failure(e)
            if err is e:
                raise
            raise err from err.__cause__

    def map_iters(self, shape, m, cams, n_iters: int, it_count: int,
                  generator: Optional[torch.Generator], intr, cfg, mcfg,
                  hyper, kf_adam=None, initialization: bool = False,
                  draws=None):
        """``map_iters`` sharded over the mesh of ``shape`` (n_view,
        n_gauss) on every rank; rank 0's ``generator`` and ``draws`` reach
        the others at the start of the call. Returns rank 0's
        ``MapResult`` (the full outputs)."""
        ts = _map_tensors(m, cams, kf_adam)
        self._post(dict(
            op="map", shape=tuple(shape), n_iters=n_iters,
            it_count=it_count, intr=intr, cfg=cfg, mcfg=mcfg, hyper=hyper,
            initialization=initialization, generator=generator is not None,
            kat=None if kf_adam is None else kf_adam[2],
            specs=[(tuple(x.shape), x.dtype) for x in ts]))

        def body():
            comm.broadcast_many(ts, dist.group.WORLD)
            mesh = self._ranks.mesh(shape)
            return sharded_map_iters(
                mesh, tuple(shape), m, cams, n_iters, it_count, generator,
                intr, cfg, mcfg, hyper, kf_adam=kf_adam,
                initialization=initialization, draws=draws)

        return self._guarded(body)

    def call(self, fn, shape, *args, gather: bool = False):
        """``fn(mesh, *args)`` on every rank of the mesh of ``shape``;
        ``fn`` is importable, ``args`` pickle (tensors reach each rank on
        its device). Returns rank 0's result, or with ``gather`` every
        rank's, in rank order (rank 0's as returned, the others' on the
        CPU)."""
        seq = self._post(dict(op="call", shape=tuple(shape), reply=gather))

        def body():
            box = [(fn, _to_cpu(args))]
            dist.broadcast_object_list(box, 0, device=_object_device(
                self.device))
            out = self._ranks.run(dict(op="call", shape=tuple(shape)),
                                  (fn, args))
            if not gather:
                return out
            outs = [out]
            for r in range(1, shape[0] * shape[1]):
                key = f"reply/{seq}/{r}"
                while not self.store.check([key]):
                    if not all(p.is_alive() for p in self.procs):
                        raise RuntimeError(f"rank {r} ended before its "
                                           "reply")
                    time.sleep(0.002)
                outs.append(pickle.loads(self.store.get(key)))
            return outs

        return self._guarded(body)

    def launches(self) -> list:
        """Every rank's kernel launches and peak device memory since the
        last ``reset_launches``, in rank order."""
        return self.call(report, (self.n_ranks, 1), gather=True)

    def reset_launches(self):
        self.call(reset, (self.n_ranks, 1))

    def stop(self):
        """End the workers and the process group; no worker outlives it.
        A group that never failed first reads every rank's launches into
        ``final_launches``."""
        if self._ranks is not None and not self._failed:
            self.final_launches = self.launches()
        if self.store is not None and any(p.is_alive() for p in self.procs):
            try:
                self._post(dict(op="stop"))
            except RuntimeError:
                pass
        for p in self.procs:
            p.join(timeout=10)
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        self.procs = []
        if dist.is_initialized():
            dist.destroy_process_group()
        self.store = None
        self._ranks = None
