"""The port's loss kernels (plain path on the CPU) against the JAX package.

``cl_tpu_torch.kernels.head_ce.head_cross_entropy`` and
``cl_tpu_torch.kernels.ce_loss.cross_entropy`` take their plain PyTorch
version for CPU tensors; they are held here against the Pallas kernels of
``cl_tpu`` (interpret mode on the CPU) and the jnp loss, on the same
seeded numpy inputs: ~10% ignore pixels and one masked class.

Tolerances: f32 at 1e-5 (the same f32 arithmetic, summed in another
order); bf16 features at one bf16 ulp for dx (the same rounded operands,
f32 sums in another order can land on the other side of one rounding)
and 1e-5 for the f32 loss, dW and db.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_tpu import losses as jax_losses
from cl_tpu.pallas import ce_loss as jax_ce
from cl_tpu.pallas import head_ce as jax_head_ce
from cl_tpu_torch import losses as port_losses
from cl_tpu_torch.kernels import ce_loss, head_ce


def _labels_valid(rng, shape, C, masked):
    valid = np.ones(C, bool)
    valid[masked] = False
    allowed = np.flatnonzero(valid)
    labels = rng.choice(allowed, size=shape).astype(np.int32)
    labels[rng.rand(*shape) < 0.1] = 255
    return labels, valid


def _bf16_ulp(x):
    x = np.maximum(np.abs(x), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _close_bf16(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    tol = _bf16_ulp(np.maximum(np.abs(a), np.abs(b))) + 1e-30
    assert np.all(np.abs(a - b) <= tol), float(np.max(np.abs(a - b) / tol))


@pytest.mark.parametrize("dtype,width", [("float32", 5), ("float32", 3),
                                         ("bfloat16", 5)])
def test_head_cross_entropy_matches_jax(dtype, width):
    rng = np.random.RandomState(0)
    B, H, W, cin, C = 2, 8, 16, 16, 5
    feats = rng.randn(B, H, W, cin).astype(np.float32)
    kernel = (rng.randn(1, 1, cin, width) * 0.3).astype(np.float32)
    bias = (rng.randn(width) * 0.1).astype(np.float32)
    labels, valid = _labels_valid(rng, (B, H, W), C, masked=C - 1)
    if width < C:  # a narrower head: classes >= width are not valid
        valid[width:] = False
        labels = np.where(labels >= width, 255, labels).astype(np.int32)

    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    fj = jnp.asarray(feats).astype(jdt)

    def jloss(f, k, b):
        return jax_head_ce.head_cross_entropy(
            f, k, b, jnp.asarray(labels), jnp.asarray(valid))

    (lj, nj), gj = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        fj, jnp.asarray(kernel), jnp.asarray(bias))

    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ft = torch.from_numpy(feats).to(tdt).requires_grad_(True)
    kt = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    lt, nt = head_ce.head_cross_entropy(ft, kt, bt, torch.from_numpy(labels),
                                        torch.from_numpy(valid))
    lt.backward()

    assert float(nt) == float(nj)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5, atol=1e-6)
    dk = kt.grad.numpy().transpose(2, 3, 1, 0)
    assert dk.shape == kernel.shape and bt.grad.shape == bias.shape
    np.testing.assert_allclose(dk, np.asarray(gj[1]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gj[2]),
                               rtol=1e-5, atol=1e-6)
    dx_j = np.asarray(gj[0].astype(jnp.float32))
    dx_t = ft.grad.float().numpy()
    assert ft.grad.dtype == tdt
    if dtype == "bfloat16":
        _close_bf16(dx_t, dx_j)
    else:
        np.testing.assert_allclose(dx_t, dx_j, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_jax(dtype):
    rng = np.random.RandomState(1)
    B, H, W, C = 2, 8, 16, 6
    logits = (rng.randn(B, H, W, C) * 2).astype(np.float32)
    labels, valid = _labels_valid(rng, (B, H, W), C, masked=2)

    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    zj = jnp.asarray(logits).astype(jdt)
    lab_j, val_j = jnp.asarray(labels), jnp.asarray(valid)
    (lj, nj), dj = jax.value_and_grad(
        lambda z: jax_ce.cross_entropy(z, lab_j, val_j), has_aux=True)(zj)
    (lr, _), dr = jax.value_and_grad(
        lambda z: jax_losses.cross_entropy(z, lab_j, val_j), has_aux=True)(zj)

    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    zt = torch.from_numpy(logits).to(tdt).requires_grad_(True)
    lt, nt = ce_loss.cross_entropy(zt, torch.from_numpy(labels),
                                   torch.from_numpy(valid))
    lt.backward()
    zp = torch.from_numpy(logits).to(tdt).requires_grad_(True)
    lp, _ = port_losses.cross_entropy(zp, torch.from_numpy(labels),
                                      torch.from_numpy(valid))
    lp.backward()

    assert float(nt) == float(nj)
    for ref in (lj, lr):
        np.testing.assert_allclose(lt.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(lp.item(), float(lr), rtol=1e-5)
    assert zt.grad.dtype == tdt
    dz = zt.grad.float().numpy()
    for ref in (dj, dr):
        ref = np.asarray(ref.astype(jnp.float32))
        if dtype == "bfloat16":
            _close_bf16(dz, ref)
        else:
            np.testing.assert_allclose(dz, ref, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(zp.grad.float().numpy(), dz, rtol=1e-5,
                               atol=1e-8 if dtype == "float32" else 1e-3)


def test_kernel_operand_checks():
    """The operand checks of the CUDA path reject what the kernels do not
    take; they run before any launch, so they are testable here."""
    x = torch.zeros(4, 70)
    w = torch.zeros(3, 70)
    with pytest.raises(ValueError):
        head_ce._check_operands(x, w, torch.zeros(4, dtype=torch.int32),
                                torch.ones(3))
    with pytest.raises(ValueError):
        ce_loss._check_operands(torch.zeros(4, 40),
                                torch.zeros(4, dtype=torch.int32),
                                torch.ones(40))
    with pytest.raises(TypeError):
        ce_loss._check_operands(torch.zeros(4, 4, dtype=torch.float16),
                                torch.zeros(4, dtype=torch.int32),
                                torch.ones(4))
