"""Weights carried between the JAX package and the port.

This package's own copy of the mapping in ``cl_tpu/interop.py`` between a
flax UNet variable tree ``{'params', 'batch_stats'}`` (as numpy arrays) and
a torch UNet state dict, plus ``load_jax_variables`` /
``export_jax_variables`` on the port's ``UNet``.

Layout mapping:
  * Conv2d weight           [O, I, kh, kw] <-> flax Conv kernel [kh, kw, I, O]
    (the 1x1 head included: [C, Cin, 1, 1] <-> [1, 1, Cin, C]).
  * ConvTranspose2d weight  [I, O, kh, kw] <-> flax ConvTranspose kernel
    [kh, kw, I, O] with both spatial axes reversed: torch's transposed conv
    flips the kernel, lax.conv_transpose does not.
  * BatchNorm weight/bias <-> scale/bias; running_mean/var <-> batch_stats
    mean/var. GroupNorm (``gn{i}``) weight/bias <-> scale/bias, with no
    batch_stats.
  * The head maps at whatever width it has: a grow-the-head tree (a head
    narrower than ``num_classes``) loads into a port UNet built with that
    ``head_width``.

Module names line up 1:1: the port's UNet names its modules after the flax
tree (enc{l}.conv{i}/bn{i}, bottleneck, up{l}, dec{l}, head).

``ewc_state_from_jax`` carries ``cl_tpu``'s EWC state (params-shaped trees
of the anchor and Fisher) into the port's flat vectors through the same
mapping, in ``model.parameters()`` order (``cl_tpu`` flattens in
``jax.tree.leaves`` order, so sums over the vectors run in another order).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _np(t) -> np.ndarray:
    # a copy: .numpy() of a CPU tensor shares its memory, which the next
    # optimizer step would change under the caller
    return t.detach().cpu().numpy().copy() if hasattr(t, "detach") \
        else np.asarray(t)


def torch_state_dict_to_variables(sd: dict[str, Any]) -> dict[str, Any]:
    """Map a torch UNet ``state_dict()`` to flax ``{'params', 'batch_stats'}``."""
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}

    def setp(tree, path, value):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value

    for name, t in sd.items():
        parts = name.split(".")
        arr = _np(t)
        if parts[-1] == "num_batches_tracked":
            continue
        *mod, leaf = parts
        if mod[-1].startswith(("bn", "gn")):
            key = {"weight": (params, "scale"), "bias": (params, "bias"),
                   "running_mean": (stats, "mean"),
                   "running_var": (stats, "var")}[leaf]
            setp(key[0], mod + [key[1]], arr)
        elif leaf == "weight":
            if mod[-1].startswith("up"):
                setp(params, mod + ["kernel"], np.ascontiguousarray(
                    arr.transpose(2, 3, 0, 1)[::-1, ::-1]))
            else:
                setp(params, mod + ["kernel"], arr.transpose(2, 3, 1, 0))
        elif leaf == "bias":
            setp(params, mod + ["bias"], arr)
        else:
            raise ValueError(f"unmapped torch entry {name!r}")
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


def variables_to_torch_state_dict(variables: dict[str, Any]) -> dict[str, np.ndarray]:
    """Inverse mapping (numpy arrays)."""
    sd: dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
            return
        arr = np.asarray(node)
        mod, leaf = path[:-1], path[-1]
        name = ".".join(mod)
        if leaf == "kernel":
            if mod[-1].startswith("up"):
                sd[name + ".weight"] = np.ascontiguousarray(
                    arr[::-1, ::-1].transpose(2, 3, 0, 1))
            else:
                sd[name + ".weight"] = arr.transpose(3, 2, 0, 1)
        elif leaf == "scale":
            sd[name + ".weight"] = arr
        elif leaf == "bias":
            sd[name + ".bias"] = arr
        elif leaf == "mean":
            sd[name + ".running_mean"] = arr
        elif leaf == "var":
            sd[name + ".running_var"] = arr
        else:
            raise ValueError(f"unmapped flax leaf {'.'.join(path)!r}")

    walk(variables.get("params", {}), [])
    walk(variables.get("batch_stats", {}), [])
    return sd


def output_channel_dim(name: str) -> int:
    """The output-channel dim of a port weight named ``name`` (the last
    axis of its flax kernel): 1 for a transposed conv's [I, O, kh, kw],
    else 0."""
    return 1 if name.split(".")[0].startswith("up") else 0


def load_jax_variables(model: torch.nn.Module, variables: dict[str, Any]) -> None:
    """Fill ``model`` (the port's UNet) from a flax variable tree of numpy
    arrays. Every entry of the model must be given; copies keep each
    tensor's device and memory format."""
    sd = {k: torch.from_numpy(np.array(v, np.float32))
          for k, v in variables_to_torch_state_dict(variables).items()}
    model.load_state_dict(sd, strict=True)


def export_jax_variables(model: torch.nn.Module) -> dict[str, Any]:
    """The port's UNet as a flax variable tree of numpy arrays."""
    return torch_state_dict_to_variables(model.state_dict())


def flat_from_params_tree(model: torch.nn.Module, tree: dict[str, Any]) -> torch.Tensor:
    """A flax ``params``-shaped tree (numpy leaves, the transposed-conv flip
    included) as one f32 vector in ``model.parameters()`` order, on the
    CPU."""
    sd = variables_to_torch_state_dict({"params": tree})
    return torch.cat([torch.from_numpy(np.array(sd[name], np.float32)).reshape(-1)
                      for name, _ in model.named_parameters()])


def _slot(tree, t: int):
    if isinstance(tree, dict):
        return {k: _slot(v, t) for k, v in tree.items()}
    return np.asarray(tree)[t]


def ewc_state_from_jax(model: torch.nn.Module, state, *, mode: str):
    """``cl_tpu.methods.ewc.EWCState`` (its anchor and Fisher trees as
    numpy or JAX arrays; a leading task axis in ``separate`` mode) as the
    port's ``methods.ewc.EWCState`` on the model's device."""
    from cl_tpu_torch.methods.ewc import EWCState

    dev = next(model.parameters()).device
    if mode == "online":
        anchor, fisher = (flat_from_params_tree(model, t) for t in (state.anchor, state.fisher))
    elif mode == "separate":
        T = np.asarray(next(iter(_leaves(state.anchor)))).shape[0]
        anchor, fisher = (torch.stack([flat_from_params_tree(model, _slot(tree, t))
                                       for t in range(T)])
                          for tree in (state.anchor, state.fisher))
    else:
        raise ValueError(f"unknown ewc mode {mode!r}")
    return EWCState(anchor=anchor.to(dev), fisher=fisher.to(dev),
                    weight=torch.tensor(float(np.asarray(state.weight)), dtype=torch.float32,
                                        device=dev),
                    n_tasks=int(np.asarray(state.n_tasks)))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
