"""Process bootstrap and rank helpers (counterpart of
neumesh_tpu/parallel/dist.py) on torch.distributed, one process per GPU.

The process group is described by torchrun's environment (MASTER_ADDR,
MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE) or, under
SLURM, synthesised from SLURM_* variables. Ranks form a (batch x data)
grid: host = rank // LOCAL_WORLD_SIZE is the batch index (images shard
over hosts), local = rank % LOCAL_WORLD_SIZE the data index (the rays of
each image shard over a host's GPUs). Launch recipes:

    torchrun --nproc_per_node=<G> -m neumesh_tpu_torch.cli.train ...
    srun --ntasks=<hosts x G> --ntasks-per-node=<G> \\
        python -m neumesh_tpu_torch.cli.train ...
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as tdist

from ..utils.print_fn import log

_TORCHRUN_KEYS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def first_slurm_node(node_list: str) -> str:
    """First hostname of a SLURM_NODELIST compact spec: 'host1',
    'host1,host2', bracket ranges like 'cluster-[003-010,012]' /
    'node[1,5-7]', and mixed lists like 'nodeA,nodeB[01-05]'. The list is
    split on commas outside brackets first, then the first element's
    bracket range is expanded."""
    node_list = node_list.strip()
    depth = 0
    first_spec = []
    for ch in node_list:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            break
        first_spec.append(ch)
    spec = "".join(first_spec)
    if "[" not in spec:
        return spec
    head, rest = spec.split("[", 1)
    body, _, suffix = rest.partition("]")
    first = body.split(",")[0].split("-")[0]
    return head + first + suffix


def slurm_coordinator_spec(environ=None, port: int | None = None):
    """(coordinator 'host:port', number of processes, process id)
    synthesised from SLURM_* variables; None when not under SLURM. The
    port: `port`, else MASTER_PORT, else 13333."""
    env = os.environ if environ is None else environ
    if "SLURM_PROCID" not in env or "SLURM_NODELIST" not in env:
        return None
    addr = first_slurm_node(env["SLURM_NODELIST"])
    port = port or int(env.get("MASTER_PORT", 13333))
    return (f"{addr}:{port}", int(env["SLURM_NTASKS"]),
            int(env["SLURM_PROCID"]))


def _slurm_tasks_per_node(env) -> int:
    """SLURM_NTASKS_PER_NODE, else the first count of SLURM_TASKS_PER_NODE
    ('4(x2),3' -> 4), else 1."""
    spec = env.get("SLURM_NTASKS_PER_NODE") or env.get(
        "SLURM_TASKS_PER_NODE", "1")
    return int(spec.split(",")[0].split("(")[0])


def process_env(environ=None, port: int | None = None):
    """({MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE}, synthesised?): torchrun's variables where they are
    set, else synthesised from SLURM (the port: `port`, else MASTER_PORT,
    else 13333); None outside both."""
    env = os.environ if environ is None else environ
    if all(k in env for k in _TORCHRUN_KEYS):
        return {"MASTER_ADDR": env["MASTER_ADDR"],
                "MASTER_PORT": int(env["MASTER_PORT"]),
                "RANK": int(env["RANK"]),
                "WORLD_SIZE": int(env["WORLD_SIZE"]),
                "LOCAL_RANK": int(env.get("LOCAL_RANK", 0)),
                "LOCAL_WORLD_SIZE": int(env.get("LOCAL_WORLD_SIZE", 1))}, \
            False
    slurm = slurm_coordinator_spec(env, port)
    if slurm is None:
        return None
    addr, world, rank = slurm
    host, _, master_port = addr.rpartition(":")
    return {"MASTER_ADDR": host, "MASTER_PORT": int(master_port),
            "RANK": rank, "WORLD_SIZE": world,
            "LOCAL_RANK": int(env.get("SLURM_LOCALID", 0)),
            "LOCAL_WORLD_SIZE": _slurm_tasks_per_node(env)}, True


def is_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def init_env(args=None, seed: int = 42, backend: str | None = None) -> int:
    """Join the process group described by torchrun's or SLURM's
    environment (nothing to join outside both), once, and seed numpy.

    The device: args.device (default "cuda"); an index-less "cuda" is this
    rank's cuda:LOCAL_RANK. The backend: nccl for a CUDA device, gloo for
    the CPU; `backend` overrides it (gloo over CUDA tensors runs two ranks
    on one card, which nccl refuses). Variables synthesised from SLURM
    are written into os.environ, so the group's env:// rendezvous and the
    rank helpers read one source (under torchrun, env:// also finds the
    launcher's store). Returns the seed."""
    get = getattr(args, "get", None)
    port = get("port", None) if callable(get) else None
    found = process_env(port=port)
    if found is not None and not is_initialized():
        spec, synthesised = found
        if synthesised:
            os.environ.update({k: str(v) for k, v in spec.items()})
        device = torch.device((get("device", None) if callable(get) else
                               None) or "cuda")
        if device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", spec["LOCAL_RANK"])
            torch.cuda.set_device(device)
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        tdist.init_process_group(backend=backend, init_method="env://",
                                 world_size=spec["WORLD_SIZE"],
                                 rank=spec["RANK"])
        log.info(f"process group: rank {spec['RANK']}/{spec['WORLD_SIZE']} "
                 f"({backend}, local {spec['LOCAL_RANK']}/"
                 f"{spec['LOCAL_WORLD_SIZE']}, {device})")
    np.random.seed(seed)
    return seed


def shutdown() -> None:
    """Leave the process group (nothing outside one)."""
    if is_initialized():
        tdist.destroy_process_group()


def process_index() -> int:
    return tdist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return tdist.get_world_size() if is_initialized() else 1


def is_master() -> bool:
    return process_index() == 0


def local_world_size() -> int:
    """Ranks of this host: LOCAL_WORLD_SIZE under a group, else 1."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", 1)) if is_initialized() \
        else 1


def local_rank() -> int:
    return process_index() % local_world_size()


def local_device_count() -> int:
    return torch.cuda.device_count()


def global_device_count() -> int:
    """The GPUs of the group (one a rank), or this host's without one."""
    return process_count() if is_initialized() else local_device_count()


def default_device() -> torch.device:
    """This rank's card, cuda:LOCAL_RANK, under a process group; the
    index-less "cuda" (the current device) without one."""
    if is_initialized():
        return torch.device("cuda", local_rank())
    return torch.device("cuda")
