"""Multi-process runtime (counterpart of ``mri_inr_tpu/parallel/distributed.py``).

Every rank runs the same program; one ``torch.distributed`` process group
joins them, and only the primary (rank 0) writes artifacts. Ranks are
started in one of two ways, read from the environment by :func:`initialize`:

- ``torchrun --nproc-per-node N -m mri_inr_tpu_torch.cli.train ...`` sets
  ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
  ``MASTER_PORT``;
- the JAX package's triple ``MRI_INR_COORDINATOR`` (``host:port``, or an
  init URL such as ``file:///shared/rendezvous``), ``MRI_INR_NUM_PROCESSES``
  and ``MRI_INR_PROCESS_ID``, all three set together.

With neither, or with one rank, the run is one process and nothing here
creates a process group.

The default group is gloo: it carries barriers and the host values
(:func:`all_gather_host_values`, :func:`broadcast_from_primary`). Tensor
collectives go through :func:`collective_group`: an NCCL group when every
rank has a card of its own, the gloo group otherwise (on the CPU, and when
ranks share a card, which NCCL refuses). The choice is logged once, by the
primary. Under gloo a CUDA tensor crosses the host (:func:`host_staged`).

A rank's card is ``cuda:LOCAL_RANK`` unless the caller names one (the
triple's route takes ``LOCAL_RANK`` from the environment when set, else the
process id); a local rank at or past ``torch.cuda.device_count()`` raises.
The rendezvous and every collective time out after
``MRI_INR_DIST_TIMEOUT`` seconds (default :data:`DEFAULT_TIMEOUT_SECONDS`)
and raise: a rank that never arrives does not hang the others.
"""

from __future__ import annotations

import datetime
import os
import socket
from dataclasses import dataclass

import torch
import torch.distributed as dist

from mri_inr_tpu_torch.utils.device import resolve_device

DEFAULT_TIMEOUT_SECONDS = 300.0
TIMEOUT_ENV = "MRI_INR_DIST_TIMEOUT"
TRIPLE = ("MRI_INR_COORDINATOR", "MRI_INR_NUM_PROCESSES", "MRI_INR_PROCESS_ID")


@dataclass
class _Ranks:
    rank: int
    world: int
    device: torch.device
    group: dist.ProcessGroup


_ranks: _Ranks | None = None


def _launch() -> tuple[str, int, int, int] | None:
    """(init method, rank, world size, local rank) from the environment."""
    if any(v in os.environ for v in TRIPLE):
        missing = [v for v in TRIPLE if v not in os.environ]
        if missing:
            raise ValueError(f"{' and '.join(missing)} not set: the three variables "
                             f"{', '.join(TRIPLE)} must be set together")
        coordinator = os.environ["MRI_INR_COORDINATOR"]
        rank = int(os.environ["MRI_INR_PROCESS_ID"])
        method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        return (method, rank, int(os.environ["MRI_INR_NUM_PROCESSES"]),
                int(os.environ.get("LOCAL_RANK", rank)))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank = int(os.environ["RANK"])
        return ("env://", rank, int(os.environ["WORLD_SIZE"]),
                int(os.environ.get("LOCAL_RANK", rank)))
    return None


def _rank_device(device, local_rank: int) -> torch.device:
    if device is None or str(device) == "cuda":
        if not torch.cuda.is_available():
            resolve_device("cuda")  # raises, naming device='cpu'
        dev = torch.device("cuda", local_rank)
    else:
        dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if dev.index >= count:
            raise ValueError(
                f"this rank's card cuda:{dev.index} is at or past the {count} card(s) "
                "visible here: start at most that many ranks a host, or name one card "
                "for every rank (--device cuda:0)")
        torch.cuda.set_device(dev)
    return dev


def initialize(device: str | torch.device | None = None) -> torch.device:
    """Join the ranks the environment describes and return this rank's
    device (for one process: ``resolve_device(device)``). Idempotent."""
    global _ranks
    if _ranks is not None:
        return _ranks.device
    launch = _launch()
    if launch is None or launch[2] == 1:
        return resolve_device(device)
    method, rank, world, local_rank = launch
    dev = _rank_device(device, local_rank)
    seconds = float(os.environ.get(TIMEOUT_ENV, DEFAULT_TIMEOUT_SECONDS))
    limit = datetime.timedelta(seconds=seconds)
    dist.init_process_group("gloo", init_method=method, rank=rank, world_size=world,
                            timeout=limit)
    backend, group, why = "gloo", dist.group.WORLD, "tensors on the CPU"
    if dev.type == "cuda":
        places: list = [None] * world
        dist.all_gather_object(places, (socket.gethostname(), dev.index))
        if len(set(places)) == world:
            backend, why = "nccl", "every rank has a card of its own"
            group = dist.new_group(backend="nccl", timeout=limit)
        else:
            why = ("ranks share a card, which NCCL refuses; CUDA tensors cross the host")
    _ranks = _Ranks(rank, world, dev, group)
    if rank == 0:
        print(f"distributed: {world} ranks, collectives over {backend} ({why}); "
              f"timeout {seconds:g} s")
    return dev


def shutdown() -> None:
    """Leave the process group (a no-op for one process)."""
    global _ranks
    if _ranks is not None:
        dist.destroy_process_group()
        _ranks = None


def process_index() -> int:
    return _ranks.rank if _ranks else 0


def process_count() -> int:
    return _ranks.world if _ranks else 1


def is_primary() -> bool:
    """True on the rank that writes checkpoints and artifacts."""
    return process_index() == 0


def rank_world(group) -> tuple[int, int]:
    """(this rank's index, the number of ranks) in ``group``; (0, 1) for
    None, one process."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def collective_group() -> dist.ProcessGroup | None:
    """The group of the tensor collectives (None for one process)."""
    return _ranks.group if _ranks else None


def sync_hosts(name: str = "sync") -> None:
    """Barrier across ranks (a no-op for one process). ``name`` says which
    barrier a timeout's message was at."""
    if process_count() > 1:
        try:
            dist.barrier()
        except RuntimeError as err:
            raise RuntimeError(f"barrier {name!r}: {err}") from err


def all_gather_host_values(values) -> list:
    """Every rank's ``values`` (any picklable object), in rank order."""
    if process_count() == 1:
        return [values]
    out: list = [None] * process_count()
    dist.all_gather_object(out, values)
    return out


def broadcast_from_primary(value):
    """The primary's ``value`` on every rank (e.g. the run directory's
    timestamp, so that every rank names one directory)."""
    if process_count() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any (e.g. a SIGTERM that
    reached one rank stops them all after the same epoch)."""
    if process_count() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))])
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def host_staged(t: torch.Tensor, group) -> bool:
    """Whether a collective on ``t`` crosses the host: a CUDA tensor under
    gloo (whose send and receive take CPU tensors only)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_mean_(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` replaced in place by its mean over the group's ranks (the
    counterpart of ``lax.pmean``): a sum, then a division by the ranks."""
    wire = t.cpu() if host_staged(t, group) else t
    dist.all_reduce(wire, group=group)
    wire.div_(dist.get_world_size(group))
    if wire is not t:
        t.copy_(wire)
    return t


def all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` (one shape on all ranks), in rank order, on
    ``t``'s device."""
    wire = t.cpu() if host_staged(t, group) else t.contiguous()
    out = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, wire, group=group)
    return [o.to(t.device) for o in out]
