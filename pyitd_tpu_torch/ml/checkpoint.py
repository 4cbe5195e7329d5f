"""Training-state checkpoints: port of ``pyitd_tpu/ml/checkpoint.py``.

The JAX package writes orbax checkpoints that restore sharding-aware.  The
port writes ``torch.distributed.checkpoint`` (DCP) checkpoints: a state is
a dict of tensors, module ``state_dict``s and optimizer ``state_dict``s
(nested dicts and lists, plain values beside the tensors); each tensor is
read back into the tensor of the same name in ``like``, on its device (and
a ``DTensor`` with its placements), so a resumed run continues bitwise.
DCP needs no process group in one process.
"""
from __future__ import annotations

import os
import shutil
import warnings
from typing import Any

import torch

__all__ = ["save_state", "restore_state"]


def _dcp():
    import torch.distributed.checkpoint as dcp

    return dcp


def _call(fn, *args, **kwargs):
    """A DCP call, in one process when no process group is up (DCP warns
    that it assumes so)."""
    dist = torch.distributed
    single = not (dist.is_available() and dist.is_initialized())
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is "
                                "disabled, unavailable or uninitialized")
        return fn(*args, no_dist=single, **kwargs)


def save_state(path: str | os.PathLike, state: Any) -> None:
    """Write ``state`` to the directory ``path``, replacing any checkpoint
    there: the new one is written beside it and renamed into place.  With
    a process group up, every rank calls it (each writes its shards) and
    rank 0 renames."""
    dist = torch.distributed
    group = dist.is_available() and dist.is_initialized()
    lead = not group or dist.get_rank() == 0
    path = os.path.abspath(os.fspath(path))
    tag = "" if group else f"-{os.getpid()}"
    tmp, old = f"{path}.writing{tag}", f"{path}.old{tag}"
    if lead:
        shutil.rmtree(tmp, ignore_errors=True)
    if group:
        dist.barrier()
    _call(_dcp().save, state, checkpoint_id=tmp)
    if group:
        dist.barrier()
    if lead:
        if os.path.exists(path):
            os.rename(path, old)
            os.rename(tmp, path)
            shutil.rmtree(old)
        else:
            os.rename(tmp, path)
    if group:
        dist.barrier()


def _is_optimizer_state(container) -> bool:
    return isinstance(container, dict) and "param_groups" in container


def _complete(like, metadata):
    """``like`` with every entry the checkpoint holds and ``like`` lacks
    added as an empty tensor of the stored shape and dtype (on the CPU) or
    a placeholder for a plain value: a fresh optimizer's ``state_dict`` has
    no per-parameter state yet.  DCP names an optimizer's integer state keys
    by their digits; they go back in as integers."""
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    for fqn, meta in metadata.state_dict_metadata.items():
        path = metadata.planner_data[fqn]
        node, parent = like, None
        for depth, key in enumerate(path):
            if (isinstance(key, str) and key.isdigit() and depth > 0
                    and path[depth - 1] == "state"
                    and _is_optimizer_state(parent)):
                key = int(key)
            last = depth == len(path) - 1
            if isinstance(node, list):
                while len(node) <= key:
                    node.append(None)
                present = node[key] is not None
            else:
                present = key in node
            if last:
                if not present:
                    node[key] = (torch.empty(
                        tuple(meta.size), dtype=meta.properties.dtype)
                        if isinstance(meta, TensorStorageMetadata) else None)
                break
            if not present:
                node[key] = [] if isinstance(path[depth + 1], int) else {}
            parent, node = node, node[key]
    return like


def restore_state(path: str | os.PathLike, like: Any) -> Any:
    """Read the checkpoint at ``path`` into ``like`` and return it.

    ``like`` is the state's structure with live tensors (a fresh model's
    ``state_dict()``, an optimizer's, tensors): each stored tensor is
    copied into ``like``'s tensor of the same name, in place and on its
    device; entries ``like`` lacks (a fresh optimizer's per-parameter
    state) are created on the CPU, where the optimizer's
    ``load_state_dict`` moves them to its parameters."""
    dcp = _dcp()
    reader = dcp.FileSystemReader(os.path.abspath(os.fspath(path)))
    state = _complete(like, reader.read_metadata())
    _call(dcp.load, state, storage_reader=reader)
    return state
