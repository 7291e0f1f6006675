"""The augment kernels' plain versions (#15 the image, #16 the mask) against
``cl_tpu.pallas.augment.augment`` in interpret mode, on the CPU, and the
tap tables the CUDA kernel reads.

Image within 1e-5 (f32) or one bf16 ulp (bf16): the same products in
another order (XLA's CPU dot against torch's einsum) give a few f32 ulps
of a value ≤ 255 before the normalization. Mask exact. The tap tables
rebuild the dense bilinear matrix bit for bit at every shape of the
presets, so the kernel's two two-tap passes are the dense products with
the zero terms left out.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_tpu.pallas import augment as jax_augment
from cl_tpu_torch import augment as port_augment
from cl_tpu_torch.data import resize
from cl_tpu_torch.kernels import augment as kernels
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _inputs(src, seed):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (3, src, src, 3)).astype(np.uint8)
    mask = rng.randint(0, 4, (3, src, src)).astype(np.uint8)
    mask[:, :2, :5] = 255
    return img, mask, np.array([True, False, True])


def _bf16_ulp(x):
    """One bf16 ulp of each f32 value (8 bits of mantissa)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("src", [40, 50])
def test_plain_versions_match_the_pallas_kernels(src, dtype):
    img, mask, flip = _inputs(src, src)
    xj, yj = jax_augment.augment(jnp.asarray(img), jnp.asarray(mask), jnp.asarray(flip),
                                 out_size=32, mean=MEAN, std=STD,
                                 compute_dtype=getattr(jnp, dtype))
    t = [torch.from_numpy(a) for a in (img, mask, flip)]
    x = kernels.image_plain(t[0], t[2], out_size=32, mean=MEAN, std=STD,
                            compute_dtype=getattr(torch, dtype))
    y = kernels.mask_plain(t[1], t[2], out_size=32)
    assert x.shape == (3, 32, 32, 3) and x.dtype == getattr(torch, dtype)
    assert y.dtype == torch.int32
    np.testing.assert_array_equal(y.numpy(), np.asarray(yj))
    got = x.float().numpy()
    want = np.asarray(jnp.asarray(xj, jnp.float32))
    tol = 1e-5 if dtype == "float32" else _bf16_ulp(want)
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


@pytest.mark.parametrize("src,dst", [(576, 512), (320, 256), (160, 128), (50, 32),
                                     (40, 32), (20, 40), (7, 5)])
def test_taps_rebuild_the_bilinear_matrix(src, dst):
    lo, hi, wlo, whi, nidx = (t.numpy() for t in kernels._taps(src, dst, torch.device("cpu")))
    dense = np.zeros((dst, src), np.float32)
    rows = np.arange(dst)
    dense[rows, lo] = wlo
    one_tap = hi == lo
    assert np.all(whi[one_tap] == 0)
    dense[rows[~one_tap], hi[~one_tap]] = whi[~one_tap]
    np.testing.assert_array_equal(dense, resize.bilinear_matrix(src, dst))
    np.testing.assert_array_equal(nidx, resize.nearest_indices(src, dst))
    if src < dst:  # an upsample clamps its edge rows into one tap of 1.0
        assert one_tap[0] and wlo[0] == 1.0


def test_kernel_route_on_the_cpu_is_the_plain_version():
    """``use_kernels`` on CPU tensors runs the plain versions (bit for
    bit) and launches nothing."""
    img, mask, flip = (torch.from_numpy(a) for a in _inputs(40, 1))
    before = dict(kernels.LAUNCHES)
    kw = dict(out_size=32, mean=MEAN, std=STD, compute_dtype=torch.bfloat16)
    x1, y1 = port_augment.augment(img, mask, flip, use_kernels=True, **kw)
    x0, y0 = port_augment.augment(img, mask, flip, **kw)
    assert torch.equal(x1, x0) and torch.equal(y1, y0)
    assert kernels.LAUNCHES == before
