"""Run calls on every rank of a fresh process group, one process per rank.

`spmd(nranks, calls, device)` spawns `nranks` processes, joins them in a
`torch.distributed` group through a file store in a temporary directory (no
network port), and has every rank make the same `calls` in order; it returns
each rank's results.  A call is (target, args, kwargs): target names a
function as "package.module:function"; an argument that is a `MeshSpec`
becomes the mesh it describes (made in the same order on every rank), and a
numpy array becomes a tensor on the rank's device.  Results come back as
numpy arrays (a `KeyPoints` as its slot dict), through files; a call that
raises gives ("error", type name, message), so one group serves calls that
are meant to fail too.

The children import only this package and what the targets import: a test
module that spawns ranks is not imported by them.  The calls reach them
through a file, so that every child starts at once (arguments passed to the
spawn itself block the parent until each child in turn has unpickled them,
torch imported).  Each child runs torch on one thread, so that many ranks
share a machine's cores.
"""
from __future__ import annotations

import importlib
import os
import pickle
import tempfile
from datetime import timedelta
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


class MeshSpec(NamedTuple):
    """A mesh to make on every rank: `dims` (n,) for `make_mesh(n)`, (dp,
    sp) for `make_mesh_2d(dp, sp)`."""
    dims: tuple


def call_api(method: str, features: dict, *args, **kwargs):
    """`EfficientFeatures(**features).<method>(*args, **kwargs)`."""
    from ..api import EfficientFeatures
    return getattr(EfficientFeatures(**features), method)(*args, **kwargs)


def _resolve(target: str):
    module, name = target.split(":")
    return getattr(importlib.import_module(module), name)


def _to_host(obj):
    """Results as numpy arrays, recursively; KeyPoints as their slots."""
    from ..api import KeyPoints
    if isinstance(obj, KeyPoints):
        return {k: _to_host(v) for k, v in obj._slots.items()}
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _child(rank: int, nranks: int, tmp: str, backend: str, device: str,
           timeout_s: float):
    from . import sharding as SH
    torch.set_num_threads(1)
    with open(os.path.join(tmp, "calls.pkl"), "rb") as f:
        calls = pickle.load(f)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    store = os.path.join(tmp, "store")
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=nranks, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    meshes = {}

    def arg(a):
        if isinstance(a, MeshSpec):
            if a.dims not in meshes:
                meshes[a.dims] = (SH.make_mesh_2d(*a.dims)
                                  if len(a.dims) == 2 else
                                  SH.make_mesh(a.dims[0]))
            return meshes[a.dims]
        if isinstance(a, np.ndarray):
            return torch.from_numpy(a.copy()).to(dev)
        return a

    results = []
    try:
        for target, args, kwargs in calls:
            try:
                got = _resolve(target)(*map(arg, args),
                                       **{k: arg(v) for k, v in
                                          kwargs.items()})
                results.append(_to_host(got))
            except Exception as exc:   # an expected failure is a result
                results.append(("error", type(exc).__name__, str(exc)))
        torch.save(results, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spmd(nranks: int, calls, device: str, backend: str = "gloo",
         timeout_s: float = 300.0) -> list[list]:
    """Every rank's results of `calls` (see the module docstring), rank 0
    first.  device: where each rank computes ("cuda" or "cpu"; all ranks
    share a machine's first card); backend: "gloo" (CPU transport, the
    ranks may compute on a card) or "nccl"."""
    calls = [(t, tuple(a), dict(kw)) for t, a, kw in calls]
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "calls.pkl"), "wb") as f:
            pickle.dump(calls, f)
        mp.spawn(_child, args=(nranks, tmp, backend, device, timeout_s),
                 nprocs=nranks, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(nranks)]
