"""Process groups and meshes on torch.distributed (port of
ggllm_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a jax.sharding.Mesh whose
"model" axis carries tensor parallelism and whose "data" axis carries batch
replicas. Here every rank is a process that drives one device, and a Mesh
is this rank's view of the grid: its device, the process group of its row
of the "model" axis (the ranks it reduces with), its index in that row and
the row's collectives (parallel/comm.py), and the same of its column of the
"data" axis (the ranks of its model index, over which a batch's rows split:
engine/engine.py).

* init_distributed joins a world: from torchrun's environment (MASTER_ADDR
  / MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK) with no arguments, or from an
  explicit coordinator ("host:port" or an init URL such as
  "file:///path"), world size and rank.
* The backend is NCCL when every rank has a card of its own, else gloo
  (CPU ranks, or ranks that share one card; parallel/comm.py stages a CUDA
  tensor's gloo collectives through host memory and counts them).
* make_mesh(data, model, devices) refuses more ranks than devices with the
  JAX message ("need N devices, have M"); `devices` lists one device a rank
  and may name one device several times (two ranks on one card).
* spawn_ranks starts ranks on this host, each a process with its own
  device, over a file:// rendezvous (the CLI's -ts N, RankPool); RankPool
  feeds such ranks jobs (tests, chip_smoke.py).
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import tempfile
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ggllm_tpu_torch.core.device import resolve_device
from ggllm_tpu_torch.parallel.comm import Comm

TIMEOUT_S = 600  # a collective that waits this long raises


def backend_for(devices) -> str:
    """"nccl" when every device is a card and no two ranks share one,
    else "gloo"."""
    devs = [torch.device(d) for d in devices]
    own = len({(d.type, d.index) for d in devs}) == len(devs)
    return "nccl" if own and all(d.type == "cuda" for d in devs) else "gloo"


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, local_device_ids=None,
                     backend: str | None = None, device=None) -> torch.device:
    """Join the world (jax.distributed.initialize's counterpart) and return
    this rank's device. No arguments: torchrun's environment, the card
    LOCAL_RANK. device: "cuda" (the default; raises where there is no card,
    or fewer than the host's ranks, as core/device.py resolve_device does)
    or "cpu"; local_device_ids: this rank's card; backend: NCCL on cards,
    gloo on the CPU, unless given ("gloo" where ranks share a card)."""
    cuda = resolve_device(device).type == "cuda"
    if coordinator_address is None:
        init = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        if cuda and local_device_ids is None:
            check_devices(int(os.environ.get("LOCAL_WORLD_SIZE", world)),
                          range(torch.cuda.device_count()))
        ids = list(local_device_ids) if local_device_ids is not None else [local]
    else:
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
        world, rank = int(num_processes), int(process_id)
        ids = list(local_device_ids) if local_device_ids is not None else [0]
    dev = torch.device("cuda", ids[0]) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if cuda else "gloo")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S), **kw)
    return dev


def default_devices() -> list[torch.device]:
    """One device a rank of the world: this host's cards, repeated for each
    host of a torchrun world (the CPU for each rank without CUDA)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not torch.cuda.is_available():
        return [torch.device("cpu")] * world
    n = torch.cuda.device_count()
    hosts = max(1, world // int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    return [torch.device("cuda", i) for _ in range(hosts) for i in range(n)]


def check_devices(n: int, devices) -> None:
    """make_mesh's refusal of a mesh larger than the devices."""
    if n > len(devices):
        raise ValueError(f"need {n} devices, have {len(devices)}")


@dataclass
class Mesh:
    """This rank's view of a (data, model) grid of ranks."""

    data: int
    model: int
    rank: int  # index in the model axis
    device: torch.device
    comm: Comm  # the model axis's collectives (this rank's row)
    data_rank: int = 0  # index in the data axis (the row)
    data_comm: Comm | None = None  # the data axis's (the ranks of this model index)

    def __post_init__(self):
        if self.data_comm is None:
            self.data_comm = Comm(None, [self.data_rank], self.data_rank, None)

    @property
    def backend(self) -> str | None:
        return self.comm.backend


_groups: dict = {}  # (data, model) -> the model rows' and data columns' process groups


def make_mesh(data: int = 1, model: int | None = None, devices=None) -> Mesh | None:
    """The (data, model) mesh over the world's first data * model ranks;
    rank r sits in data row r // model at model index r % model, on
    devices[r]. Called by every rank of the world (it makes process groups);
    a rank outside the mesh gets None. Without init_distributed only a
    one-rank mesh can be made, whose collectives are the identity."""
    devices = [torch.device(d) for d in (devices if devices is not None else default_devices())]
    if model is None:
        model = len(devices) // data
    n = data * model
    check_devices(n, devices)
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"a {data} x {model} mesh needs init_distributed first")
        return Mesh(1, 1, 0, devices[0], Comm(None, [0], 0, None))
    world, rank = dist.get_world_size(), dist.get_rank()
    if n > world:
        raise ValueError(f"need {n} ranks, have {world}")
    rows = [list(range(d * model, (d + 1) * model)) for d in range(data)]
    cols = [list(range(m, n, model)) for m in range(model)]
    if (data, model) not in _groups:  # every rank makes every group, in one order
        _groups[(data, model)] = (
            None if n == world and data == 1 else [dist.new_group(r) for r in rows],
            [dist.new_group(c) for c in cols] if data > 1 else None)
    if rank >= n:
        return None
    row_groups, col_groups = _groups[(data, model)]
    row, col = rank // model, rank % model
    backend = dist.get_backend()
    comm = Comm(None if row_groups is None else row_groups[row], rows[row], col, backend)
    data_comm = None if col_groups is None else Comm(col_groups[col], cols[col], row, backend)
    return Mesh(data, model, col, devices[rank], comm, row, data_comm)


# ------------------------------------------------------------ rank processes

@dataclass
class World:
    """An n-rank world on this host: its file:// rendezvous (in `dir`), its
    backend, its devices (rank r on devices[r]) and the spawned ranks."""

    n: int
    init: str
    dir: str
    backend: str
    devices: list
    procs: list

    def join(self, rank: int) -> torch.device:
        """init_distributed as rank `rank` of this world."""
        dev = torch.device(self.devices[rank])
        return init_distributed(self.init, self.n, rank,
                                [dev.index] if dev.type == "cuda" else None,
                                backend=self.backend, device=dev.type)


def spawn_ranks(n: int, devices, target, args=(), start: int = 0,
                workdir: str | None = None) -> World:
    """Ranks start .. n - 1 of an n-rank world on this host, each a spawned
    process calling target(world, rank, *args) (a module-level function
    that joins with world.join(rank)); the caller joins as the ranks below
    `start`. Refuses more ranks than devices; the rendezvous is a file://
    store in a fresh temporary directory under workdir."""
    devices = [str(d) for d in devices]
    check_devices(n, devices)
    devices = devices[:n]
    d = tempfile.mkdtemp(prefix="ggllm_ranks_", dir=workdir)
    world = World(n, "file://" + os.path.join(d, "rendezvous"), d, backend_for(devices),
                  devices, [])
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(world, r, *args), daemon=True)
             for r in range(start, n)]
    for p in procs:
        p.start()  # (pickles `world` while its procs is still empty)
    world.procs = procs
    return world


def _rank_main(world: World, rank: int, inqs, outq) -> None:
    torch.set_num_threads(1)
    try:
        world.join(rank)
        outq.put((rank, True, None))
    except BaseException:
        outq.put((rank, False, traceback.format_exc()))
        return
    while True:
        job = inqs[rank].get()
        if job is None:
            break
        fn, args, kwargs = job
        try:
            outq.put((rank, True, fn(*args, **kwargs)))
        except BaseException:
            outq.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """n rank processes on this host (spawn_ranks), rank r on devices[r]
    (default: the CPU), over a rendezvous under `workdir` (default: the
    temporary directory). run(fn, *args) calls fn(*args) on every rank (fn
    importable by the rank processes: a module-level function) and returns
    the results in rank order; fn makes its mesh with make_mesh(...,
    devices=) itself. A job that fails on any rank ends the pool (ranks
    left waiting in a collective would never return) and raises with every
    rank's traceback; the next run starts a new pool."""

    def __init__(self, n: int, devices=None, workdir: str | None = None):
        self.n = n
        self.devices = [str(d) for d in (devices or ["cpu"] * n)]
        check_devices(n, self.devices)
        self.workdir = workdir
        self.procs: list = []
        self._start()

    def _start(self) -> None:
        ctx = mp.get_context("spawn")
        self.outq = ctx.Queue()
        self.inqs = [ctx.Queue() for _ in range(self.n)]
        self.procs = spawn_ranks(self.n, self.devices, _rank_main, (self.inqs, self.outq),
                                 workdir=self.workdir).procs
        self._collect("joining the world")

    def _collect(self, what: str) -> list:
        out, errors = [None] * self.n, {}
        for _ in range(self.n):
            try:
                rank, ok, val = self.outq.get(timeout=TIMEOUT_S)
            except Exception:
                errors[-1] = f"no answer within {TIMEOUT_S} s"
                break
            if ok:
                out[rank] = val
            else:
                errors[rank] = val
                break  # the others may wait in a collective for the failed rank
        if errors:
            self.close(kill=True)
            raise RuntimeError(f"rank pool: {what} failed\n" + "\n".join(
                f"-- rank {r}:\n{tb}" for r, tb in sorted(errors.items())))
        return out

    def run(self, fn, *args, **kwargs) -> list:
        if not self.procs:
            self._start()
        for q in self.inqs:
            q.put((fn, args, kwargs))
        return self._collect(getattr(fn, "__name__", str(fn)))

    def close(self, kill: bool = False) -> None:
        for p, q in zip(self.procs, getattr(self, "inqs", [])):
            if not kill and p.is_alive():
                q.put(None)
        for p in self.procs:
            p.join(timeout=0 if kill else 30)
            if p.is_alive():
                p.kill()
                p.join()
        self.procs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
