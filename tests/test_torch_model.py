"""The port's UNet against ``cl_tpu.models.unet.UNet`` from the same weights.

The flax variables (with BN scale/shift and running statistics drawn at
random, so eval mode is not the identity) are loaded into the port with
``interop.load_jax_variables``; logits, pre-head features and the updated
BatchNorm statistics must agree in f32 at 1e-4 (the same f32 arithmetic;
convolutions sum in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_tpu.models.unet import UNet as JaxUNet
from cl_tpu_torch.interop import export_jax_variables, load_jax_variables
from cl_tpu_torch.models.unet import UNet, init_weights
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NUM_CLASSES, BASE, DEPTH = 3, 8, 3


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    jm = JaxUNet(num_classes=NUM_CLASSES, base_channels=BASE, depth=DEPTH)
    # the flax tree comes from the port's seeded init (flax's own init
    # compiles for seconds on the CPU); apply() checks every name
    seeded = UNet(NUM_CLASSES, BASE, DEPTH)
    init_weights(seeded, torch.Generator().manual_seed(0))
    variables = _tree_map(np.array, export_jax_variables(seeded))

    def perturb(path_tree, kind):
        for k, v in path_tree.items():
            if isinstance(v, dict):
                perturb(v, kind)
            elif kind == "stats":
                path_tree[k] = (rng.rand(*v.shape).astype(np.float32) + 0.5
                                if k == "var" else
                                rng.randn(*v.shape).astype(np.float32) * 0.1)
            elif k in ("scale", "bias"):
                path_tree[k] = (v + rng.randn(*v.shape) * 0.1).astype(np.float32)

    perturb(variables["params"], "params")
    perturb(variables["batch_stats"], "stats")
    pm = UNet(NUM_CLASSES, BASE, DEPTH).to(memory_format=torch.channels_last)
    load_jax_variables(pm, variables)
    return x, jm, variables, pm


def test_interop_round_trip(setup):
    _, _, variables, pm = setup
    back = export_jax_variables(pm)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_eval_logits_and_features(setup):
    x, jm, variables, pm = setup
    pm.eval()
    with torch.no_grad():
        lt = pm(torch.from_numpy(x)).numpy()
        ft = pm(torch.from_numpy(x), return_features=True).numpy()
    lj = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    fj = np.asarray(jm.apply(variables, jnp.asarray(x), train=False,
                             return_features=True))
    assert lt.shape == (2, 32, 32, NUM_CLASSES) and ft.shape == (2, 32, 32, BASE)
    np.testing.assert_allclose(lt, lj, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ft, fj, rtol=1e-4, atol=1e-4)


def test_train_logits_and_batch_stats(setup):
    x, jm, variables, _ = setup
    pm = UNet(NUM_CLASSES, BASE, DEPTH).to(memory_format=torch.channels_last)
    load_jax_variables(pm, variables)
    pm.train()
    with torch.no_grad():
        lt = pm(torch.from_numpy(x)).numpy()
    lj, new_state = jm.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    np.testing.assert_allclose(lt, np.asarray(lj), rtol=1e-4, atol=1e-4)
    # flax updates the running variance with the BIASED batch variance
    got = dict(jax.tree_util.tree_leaves_with_path(
        export_jax_variables(pm)["batch_stats"]))
    want = jax.tree_util.tree_leaves_with_path(new_state["batch_stats"])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_allclose(got[path], np.asarray(leaf), rtol=1e-4,
                                   atol=1e-5)
