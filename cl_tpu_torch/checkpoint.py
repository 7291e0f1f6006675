"""L5 — per-task checkpoints and resume.

The counterpart of ``cl_tpu/checkpoint.py``. One directory per task
(``<train.checkpoint_dir>/task_{t}/``) holds:

  * ``state.pt``   — ``torch.save`` of the whole train state on the CPU:
                     the model's ``state_dict`` (params and BatchNorm
                     buffers), the optimizer's ``state_dict`` (Adam's
                     moments and its ``step``), EWC's anchor, Fisher,
                     weight and ``n_tasks``, and LwF's teacher
                     ``state_dict``, ``old_valid`` and weight;
  * ``replay.pkl`` — the replay buffer's own ``state_dict``, pickled. It
                     holds a numpy ``RandomState`` tuple, which
                     ``torch.load(weights_only=True)`` (the default since
                     torch 2.6) refuses, so it stays out of ``state.pt``;
                     either buffer reads the other's format, so a
                     checkpoint written with one resumes into the other;
  * ``meta.json``  — task id, config hash, the mIoU matrix so far. Written
                     last and atomically (tmp file, then ``os.replace``):
                     its presence marks the checkpoint complete.

``cl_tpu``'s ``TrainState`` also carries ``rng``, whose only consumer on
a path the port runs is EWC's sampled Fisher. The port needs no RNG field:
the sampled Fisher draws from a ``torch.Generator`` seeded at the start of
each Fisher pass from ``train.seed`` and the task id
(``train.fisher_generator``), the host pipeline and the device cache draw
from it in the same batch order, and data order, flips and replay draws
come from seeds and the buffer's ``RandomState``. So a resumed run draws
what the uninterrupted run drew.

Saves are asynchronous, as in ``cl_tpu``, with one difference. PyTorch
updates params, moments and buffers in place, where JAX makes new arrays:
a thread that serialised the live tensors while the next task trains
would save a torn state. So every tensor is cloned to the host before
``save_task`` returns (the one synchronous part); serialising and writing
run on a daemon thread, which writes ``meta.json`` once the state is on
disk. ``wait_for_saves()`` is the barrier: ``train()`` calls it at the end
of the run and before the fault injection raises, and every save, restore
and ``latest_task`` calls it first.

Restore loads into the objects the train step holds: ``load_state_dict``
or ``copy_`` into the model, the optimizer, EWC's tensors and the teacher,
attributes set on the same ``EWCState`` and ``LwFState``. The steps read
those objects at every call, so rebinding a name to a new state would
leave them training against the seeded init's zero teacher. The
optimizer's ``load_state_dict`` moves the moments to their param's device
and leaves Adam's ``step`` a CPU tensor, as a fresh run has it.
"""

from __future__ import annotations

import copy
import json
import os
import pickle
import threading
from dataclasses import dataclass

import numpy as np
import torch

from cl_tpu_torch.config import Config

_PENDING: list[threading.Thread] = []
_ERRORS: list[BaseException] = []


@dataclass
class TrainState:
    """The objects a run trains and the steps read: the model, its
    optimizer, and the EWC / LwF states where the config has them."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    ewc: object = None   # methods.ewc.EWCState or None
    lwf: object = None   # methods.lwf.LwFState or None


def wait_for_saves() -> None:
    """Block until every checkpoint in flight (state and meta) is on disk;
    re-raise the first failure once. Idempotent; a failure does not leak
    into later saves in the same process."""
    while _PENDING:
        _PENDING.pop().join()
    if _ERRORS:
        first = _ERRORS[0]
        _ERRORS.clear()
        raise first


def _task_dir(cfg: Config, task_id: int) -> str:
    return os.path.join(os.path.abspath(cfg.train.checkpoint_dir), f"task_{task_id}")


def _task_number(name: str) -> int | None:
    """t for a directory named ``task_{t}``; None for anything else (a
    user's ``task_old/`` or ``task_0.bak`` is not ours to manage)."""
    suffix = name.split("_", 1)[1] if name.startswith("task_") else ""
    return int(suffix) if suffix.isdigit() else None


def _to_host(obj):
    """A copy of ``obj`` with every tensor cloned to the CPU (a CPU tensor
    too: the run goes on updating its own in place)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def state_dict(state: TrainState) -> dict:
    """Everything of ``state`` a resume needs, as a tree of tensors and
    Python values (the live tensors: ``save_task`` clones them)."""
    sd = {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict()}
    if state.ewc is not None:
        e = state.ewc
        sd["ewc"] = {"anchor": e.anchor, "fisher": e.fisher, "weight": e.weight,
                     "n_tasks": int(e.n_tasks)}
    if state.lwf is not None:
        w = state.lwf
        sd["lwf"] = {"teacher": w.teacher.state_dict(), "old_valid": w.old_valid,
                     "weight": float(w.weight)}
    return sd


@torch.no_grad()
def load_state_dict(state: TrainState, sd: dict) -> TrainState:
    """Load ``sd`` into the objects of ``state`` in place."""
    state.model.load_state_dict(sd["model"])
    state.optimizer.load_state_dict(sd["optimizer"])
    if state.ewc is not None:
        e, s = state.ewc, sd["ewc"]
        e.anchor.copy_(s["anchor"])
        e.fisher.copy_(s["fisher"])
        e.weight.copy_(s["weight"])
        e.n_tasks = int(s["n_tasks"])
    if state.lwf is not None:
        w, s = state.lwf, sd["lwf"]
        w.teacher.load_state_dict(s["teacher"])
        w.old_valid.copy_(s["old_valid"])
        w.weight = float(s["weight"])
    return state


def _write(d: str, state_host: dict, replay_sd, meta: dict) -> None:
    tmp = os.path.join(d, "state.pt.tmp")
    torch.save(state_host, tmp)
    os.replace(tmp, os.path.join(d, "state.pt"))
    if replay_sd is not None:
        with open(os.path.join(d, "replay.pkl"), "wb") as f:
            pickle.dump(replay_sd, f)
    # meta.json last and atomically: its presence marks the checkpoint
    # complete, so it never exists truncated
    tmp = os.path.join(d, "meta.json.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(d, "meta.json"))


def save_task(cfg: Config, state: TrainState, replay, task_id: int,
              miou_matrix: np.ndarray, *, block: bool = False) -> str:
    """Checkpoint the run after ``task_id``: clone the state to the host,
    then write it on a daemon thread (``block``: wait for it). Returns the
    task's directory."""
    wait_for_saves()  # one save in flight at a time (tasks are sequential)
    d = _task_dir(cfg, task_id)
    os.makedirs(d, exist_ok=True)
    # A reused directory may hold a previous run's complete task_{t}: its
    # meta.json must not mark this save complete if the save fails.
    for stale in ("meta.json", "replay.pkl"):
        p = os.path.join(d, stale)
        if os.path.exists(p):
            os.remove(p)
    # Saving task t makes a previous run's task_{k>t} stale: drop their
    # markers, or a later resume would splice that run onto this one.
    root = os.path.abspath(cfg.train.checkpoint_dir)
    for name in os.listdir(root):
        k = _task_number(name)
        if k is not None and k > task_id:
            p = os.path.join(root, name, "meta.json")
            if os.path.exists(p):
                os.remove(p)
    state_host = _to_host(state_dict(state))
    # the device buffer's arrays and the host buffer's RandomState change
    # in place as the run goes on: the thread writes a copy
    replay_sd = copy.deepcopy(replay.state_dict()) if replay is not None else None
    meta = {"task_id": task_id, "config_hash": cfg.config_hash(),
            "miou_matrix": np.asarray(miou_matrix).tolist()}

    def finalize():
        try:
            _write(d, state_host, replay_sd, meta)
        except BaseException as e:  # surfaced by wait_for_saves
            _ERRORS.append(e)

    # Daemon: a crash of the main thread must not hang the process's exit
    # on a write; it loses at most this task's checkpoint, cleanly (no
    # meta.json: a resume redoes the task).
    t = threading.Thread(target=finalize, daemon=True)
    t.start()
    _PENDING.append(t)
    if block:
        wait_for_saves()
    return d


def latest_task(cfg: Config) -> int | None:
    """The last task with a complete checkpoint, or None."""
    wait_for_saves()
    root = os.path.abspath(cfg.train.checkpoint_dir)
    if not os.path.isdir(root):
        return None
    done = [k for k in map(_task_number, os.listdir(root))
            if k is not None and os.path.exists(os.path.join(root, f"task_{k}", "meta.json"))]
    return max(done) if done else None


def _meta(cfg: Config, task_id: int) -> dict:
    """The task's meta.json, refused if it was written under another
    config (``config_hash`` leaves out the operational fields: the log
    path, the fault injection, ``data.device_cache``, the buffer's
    residency)."""
    with open(os.path.join(_task_dir(cfg, task_id), "meta.json")) as f:
        meta = json.load(f)
    if meta["config_hash"] != cfg.config_hash():
        raise ValueError(
            f"checkpoint config hash {meta['config_hash']} != current "
            f"{cfg.config_hash()} — refusing to resume across configs")
    return meta


def _load(cfg: Config, task_id: int) -> dict:
    return torch.load(os.path.join(_task_dir(cfg, task_id), "state.pt"),
                      map_location="cpu", weights_only=True)


def restore_task(cfg: Config, state: TrainState, replay, task_id: int):
    """Load task ``task_id``'s checkpoint into ``state`` and ``replay``
    (in place); returns (state, replay, task_id, mIoU matrix)."""
    wait_for_saves()
    meta = _meta(cfg, task_id)
    load_state_dict(state, _load(cfg, task_id))
    path = os.path.join(_task_dir(cfg, task_id), "replay.pkl")
    if replay is not None and os.path.exists(path):
        with open(path, "rb") as f:
            replay.load_state_dict(pickle.load(f))
    return state, replay, task_id, np.asarray(meta["miou_matrix"], dtype=np.float64)


def restore_latest(cfg: Config, state: TrainState, replay):
    """``restore_task`` of the latest complete task, or None."""
    t = latest_task(cfg)
    if t is None:
        return None
    return restore_task(cfg, state, replay, t)


def restore_model(cfg: Config, model: torch.nn.Module, task_id: int) -> torch.nn.Module:
    """Load only the model (params and BatchNorm buffers) of task
    ``task_id``'s checkpoint into ``model``, in place."""
    wait_for_saves()
    _meta(cfg, task_id)
    model.load_state_dict(_load(cfg, task_id)["model"])
    return model
