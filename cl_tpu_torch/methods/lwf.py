"""LwF — learning without forgetting by knowledge distillation.

The counterpart of ``cl_tpu/methods/lwf.py``: after each task but the last
the trained model is snapshotted as a frozen teacher; while the next task
trains, the loss adds α·weight·T²·KL(softmax(teacher/T) ‖ softmax(student/T))
over the classes the teacher knew (``losses.kd_loss``, or in the packed KD
head kernels). The teacher runs in eval mode with no gradient.

``LwFState`` is mutable where the JAX one is a pytree: the train step holds
the state and reads its teacher, ``old_valid`` and ``weight`` at every
call, and ``lwf_after_task`` updates it in place. ``weight`` is a Python
float (0.0 until the first snapshot, then 1.0): it changes only between
tasks, so the step reads it without a device sync.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch

from cl_tpu_torch.models.unet import UNet


@dataclass
class LwFState:
    teacher: UNet              # frozen snapshot: eval mode, no gradient
    old_valid: torch.Tensor    # bool [C] on the device: classes it knows
    weight: float              # 0.0 until the first snapshot


def make_lwf_state(model: UNet) -> LwFState:
    """A teacher of ``model``'s shape with every param and BatchNorm buffer
    zero (``jnp.zeros_like`` of params and batch stats in ``cl_tpu``), no
    class known, weight 0. On task 0 the KD term of a zero teacher is
    finite and exactly 0 (uniform softmaxes on both sides). ``old_valid``
    spans the global label space, ``model.num_classes`` (``cl_tpu/methods/
    lwf.py:24-30``), whatever the head's width: the KD kernels take a [C]
    mask."""
    teacher = copy.deepcopy(model).eval().requires_grad_(False)
    with torch.no_grad():
        for t in teacher.state_dict().values():
            t.zero_()
    old_valid = torch.zeros(model.num_classes, dtype=torch.bool,
                            device=model.head.weight.device)
    return LwFState(teacher=teacher, old_valid=old_valid, weight=0.0)



@torch.no_grad()
def old_features(state: LwFState, x: torch.Tensor, packed: bool = False):
    """The teacher's pre-head features (eval mode): the operand of the KD
    head kernels; ``packed`` asks for the packed body's (raw, scale,
    shift)."""
    return state.teacher(x, return_features=True, packed_features=packed)


@torch.no_grad()
def old_logits(state: LwFState, x: torch.Tensor) -> torch.Tensor:
    """The teacher's logits (eval mode), for the KD on logits."""
    return state.teacher(x)


@torch.no_grad()
def lwf_after_task(state: LwFState, model: UNet,
                   seen_valid: torch.Tensor) -> LwFState:
    """Snapshot ``model`` as the teacher: its params AND BatchNorm buffers
    copied into the teacher's own storage (no tensor aliases the student,
    the port's form of ``cl_tpu``'s donation rule at ``lwf.py:79-81``),
    the seen classes as ``old_valid``, weight 1."""
    dst = state.teacher.state_dict()
    for name, t in model.state_dict().items():
        dst[name].copy_(t)
    state.old_valid.copy_(seen_valid.to(state.old_valid.device, torch.bool))
    state.weight = 1.0
    return state
