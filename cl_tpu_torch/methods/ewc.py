"""EWC — elastic weight consolidation by the diagonal Fisher information.

The counterpart of ``cl_tpu/methods/ewc.py``: after task t the diagonal
Fisher F_i = E_batch[(∂CE/∂θ_i)²] is accumulated over up to
``method.ewc_fisher_batches`` batches (``train.run_fisher_pass``) and
stored with the anchor θ*; while later tasks train, the loss adds
λ·(1/2)·Σ F_i (θ_i − θ*_i)².

The anchor and Fisher are flat f32 vectors over ``model.parameters()`` in
that fixed order (``flat_params``), the operands of the kernels in
``kernels/ewc_fused.py``; ``cl_tpu`` holds them as params-shaped trees
(``interop.ewc_state_from_jax`` carries one into the other). Modes:
``online`` keeps one consolidated (θ*, F), F ← γ·F_old + F_new after each
task; ``separate`` keeps one (θ*_t, F_t) per task as rows of [max_tasks, n]
and the penalty sums over them. The Fisher is f32 whatever the compute
dtype: g² underflows in bf16.

``EWCState`` is mutable where the JAX one is a pytree: the train step
reads it at every call and ``ewc_after_task`` updates it in place;
``expand_head_zeros`` gives it longer vectors when the head grows.
``weight`` is a 0-d f32 tensor on the device (0 until the first
consolidation, then 1), so the penalty runs from task 0 on, as in
``cl_tpu``, without a host sync.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from cl_tpu_torch import losses


@dataclass
class EWCState:
    anchor: torch.Tensor   # f32 [n] (online) or [max_tasks, n] (separate)
    fisher: torch.Tensor   # f32, the shape of anchor
    weight: torch.Tensor   # f32 0-d on the device: 0 until the first consolidation
    n_tasks: int           # tasks consolidated so far


def flat_params(model: torch.nn.Module) -> torch.Tensor:
    """θ: every param of ``model`` as one f32 vector, in
    ``model.parameters()`` order (differentiable: a fresh tensor, never a
    view of a param)."""
    return torch.cat([p.reshape(-1).float() for p in model.parameters()])


def n_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def make_ewc_state(model: torch.nn.Module, *, mode: str, max_tasks: int = 1) -> EWCState:
    """Zero anchor and Fisher on the model's device, weight 0."""
    dev = next(model.parameters()).device
    n = n_params(model)
    if mode == "online":
        shape = (n,)
    elif mode == "separate":
        shape = (max_tasks, n)
    else:
        raise ValueError(f"unknown ewc mode {mode!r}")
    return EWCState(anchor=torch.zeros(shape, dtype=torch.float32, device=dev),
                    fisher=torch.zeros(shape, dtype=torch.float32, device=dev),
                    weight=torch.zeros((), dtype=torch.float32, device=dev), n_tasks=0)


def penalty(theta: torch.Tensor, state: EWCState, *, mode: str) -> torch.Tensor:
    """(1/2)·weight·Σ F (θ−θ*)² summed over the stored tasks, plain
    PyTorch (``cl_tpu/methods/ewc.py:55-71``; the path of
    ``train.use_pallas=false``). ``theta``: ``flat_params(model)``."""
    if mode == "online":
        d = theta - state.anchor
    elif mode == "separate":
        d = theta[None] - state.anchor
    else:
        raise ValueError(f"unknown ewc mode {mode!r}")
    return 0.5 * state.weight * (state.fisher * d * d).sum()


@torch.no_grad()
def sample_fisher_labels(logits: torch.Tensor, y: torch.Tensor, valid_classes: torch.Tensor,
                         generator: torch.Generator, *, ignore_index: int = 255,
                         dp=None) -> torch.Tensor:
    """The sampled Fisher's labels (``kind="true"``, ``cl_tpu/methods/ewc.py:
    103-108``): one class a pixel drawn from softmax(mask_logits(logits)),
    the ignore label kept where ``y`` has it. ``cl_tpu`` draws with
    ``jax.random.categorical``; the port by the Gumbel-max trick, argmax of
    the masked f32 logits minus log(−log U), U from ``torch.rand`` on
    ``generator`` (on the logits' device: no host wait). A masked class
    (−1e9) is never drawn: −log(−log U) lies within [−4.5, 16.7] for U in
    [2⁻¹²⁶, 1 − 2⁻²⁴]. Returns labels of ``y``'s dtype. With ``dp`` (a
    ``sharding.DataParallel``; ``logits`` this rank's part: its rows of the
    batch, or under spatial parallelism its rows of the image) U is drawn
    over the GLOBAL logits, as one process draws it, and the rank takes its
    part of that draw."""
    z = losses.mask_logits(logits.float(), valid_classes)
    shape = z.shape if dp is None else dp.global_shape(z.shape)
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=z.device)
    if dp is not None:
        u = dp.own(u)
    gumbel = -torch.log(-torch.log(u.clamp_min_(torch.finfo(torch.float32).tiny)))
    sampled = torch.argmax(z + gumbel, dim=-1)
    return torch.where(y == ignore_index, y, sampled.to(y.dtype))


def fisher_batch_grads(model: torch.nn.Module, x, y, valid_classes, *,
                       ignore_index: int = 255,
                       generator: torch.Generator | None = None, dp=None) -> torch.Tensor:
    """The Fisher's raw gradient of one batch (``cl_tpu/methods/ewc.py:74-115``
    with ``square=False``): ∂CE/∂θ, the model in eval mode (running
    statistics, which do not move), as one flat f32 vector in
    ``flat_params`` order. The labels are ``y`` (the empirical Fisher), or
    with ``generator`` drawn by ``sample_fisher_labels`` from this
    forward's logits (the sampled Fisher: ``cl_tpu`` runs the forward
    twice, once to draw and once under ``jax.grad``, on the same params and
    input). The gradients come from ``torch.autograd.grad``: no param's
    ``.grad`` changes. With ``dp`` (``x``, ``y`` this rank's rows) it is
    the gradient of the global batch's mean CE (``cl_tpu`` under a mesh):
    each rank's share, summed over the group, which the caller squares."""
    model.eval()
    params = list(model.parameters())
    logits = model(x)
    if generator is not None:
        y = sample_fisher_labels(logits, y, valid_classes, generator, ignore_index=ignore_index,
                                 dp=dp)
    ce, _ = losses.cross_entropy(logits, y, valid_classes, ignore_index=ignore_index, dp=dp)
    grads = torch.autograd.grad(ce, params)
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    return flat if dp is None else dp.all_reduce_(flat)


@torch.no_grad()
def expand_head_zeros(state: EWCState, model: torch.nn.Module, old_width: int) -> EWCState:
    """Re-lay the anchor and Fisher, in place on ``state``, for ``model``
    whose head has just grown from ``old_width`` rows (``cl_tpu``'s
    ``expand_head_zeros`` on the EWC trees, ``train.py:926-930``): zeros
    at the new rows, so no penalty falls on classes that post-date the
    stored state. The head's weight [width, Cin, 1, 1] and bias are the
    last two params of the flat order, each row-major, so the new rows
    append at the end of the weight's block and of the bias's block.
    Both modes: the last axis of [n] or [max_tasks, n]."""
    names = [n for n, _ in model.named_parameters()]
    if names[-2:] != ["head.weight", "head.bias"]:
        raise ValueError(f"the head must be the last params of the flat order, not {names[-2:]}")
    new_width, cin = model.head.weight.shape[:2]
    k = new_width - old_width
    if k <= 0:
        return state

    def relay(v):
        head_w, head_b = old_width * cin, old_width
        body, w, b = v.split([v.shape[-1] - head_w - head_b, head_w, head_b], dim=-1)
        return torch.cat([body, w, v.new_zeros(v.shape[:-1] + (k * cin,)),
                          b, v.new_zeros(v.shape[:-1] + (k,))], dim=-1)

    state.anchor = relay(state.anchor)
    state.fisher = relay(state.fisher)
    return state


@torch.no_grad()
def ewc_after_task(state: EWCState, model: torch.nn.Module, fisher_new: torch.Tensor, *,
                   mode: str, gamma: float, task_id: int) -> EWCState:
    """Consolidate after ``task_id`` (``cl_tpu/methods/ewc.py:118-135``):
    the anchor becomes an f32 copy of the params in the state's own storage
    (never a param's), the Fisher γ·F_old + F_new (online) or slot
    ``task_id`` of both is written (separate); weight 1."""
    theta = flat_params(model)
    if mode == "online":
        state.anchor.copy_(theta)
        state.fisher.copy_(gamma * state.fisher + fisher_new)
    elif mode == "separate":
        state.anchor[task_id].copy_(theta)
        state.fisher[task_id].copy_(fisher_new)
    else:
        raise ValueError(f"unknown ewc mode {mode!r}")
    state.weight.fill_(1.0)
    state.n_tasks += 1
    return state
