"""The 2-D ``("data", "model")`` mesh and its conv-channel sharding rule in
the port (``sharding.make_mesh_2d`` / ``param_specs``) against
``cl_tpu.sharding`` ("TP readiness", ``tests/dp/test_mesh.py:114-137``), on
the CPU: one gloo group of 8 processes, spawned once for the module as a
2 × 4 mesh.

* ``param_specs`` shards the same weights as ``cl_tpu``'s rule on its
  2 × 4 mesh of ``conftest``'s 8 virtual devices (a 4-D weight whose
  output channels number at least ``min_channels`` and divide by the model
  axis; the port's names mapped to flax's leaves through ``interop``), each
  rank holding a quarter of each sharded weight's output channels, and
  replicates everything on a 1-D mesh;
* the forward from weights stored as shards (gathered at use over the
  model axis) on each data row's images equals the replicated model's
  logits within 1e-4 (``cl_tpu``'s tolerance);
* ``make_mesh_2d`` raises ``ValueError`` where the model axis does not
  divide the world.

The module's top-level imports are torch-only: the spawned workers import
it and must load neither JAX nor ``cl_tpu``.
"""

import numpy as np
import pytest
import torch

from cl_tpu_torch import sharding
from cl_tpu_torch.interop import export_jax_variables, load_jax_variables
from cl_tpu_torch.models.unet import UNet, init_weights
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MIN_CHANNELS = 16


def _model():
    model = UNet(3, base_channels=16, depth=2, norm="group")
    init_weights(model, torch.Generator().manual_seed(0))
    return model


def _images():
    return np.random.RandomState(1).randn(4, 32, 32, 3).astype(np.float32)


def _flax_path(name):
    """The flax leaf of a port conv weight (``interop``'s mapping)."""
    return tuple(name.split(".")[:-1]) + ("kernel",)


def mesh_run():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    torch.set_num_threads(1)
    model = _model()
    mesh = sharding.make_mesh_2d(4, device_type="cpu")
    specs = sharding.param_specs(model, mesh, min_channels=MIN_CHANNELS)
    shards = sharding.shard_params(model, mesh, specs)
    data = mesh.get_coordinate()[0]
    rows = slice(2 * data, 2 * data + 2)  # the data axis's 2 rows of 2 images each
    with torch.no_grad():
        out = sharding.gathered_forward(model, torch.from_numpy(_images()[rows]), shards)
    flat = init_device_mesh("cpu", (8,), mesh_dim_names=("data",))
    return {"sharded": {n: p[1].dim for n, p in specs.items() if isinstance(p[1], Shard)},
            "replicated": [n for n, p in specs.items() if p == (Replicate(), Replicate())],
            "local": {n: tuple(t.to_local().shape) for n, t in shards.items()},
            "rows": rows, "out": out,
            "flat": all(p == (Replicate(),) for p in sharding.param_specs(
                model, flat, min_channels=MIN_CHANNELS).values())}


@pytest.fixture(scope="module")
def group8(tmp_path_factory):
    store = tmp_path_factory.mktemp("mesh_store") / "store"
    return sharding.spawn(mesh_run, (), world=8, backend="gloo",
                          init_method=f"file://{store}", devices=["cpu"] * 8, timeout=600)


@pytest.fixture(scope="module")
def cl_tpu_sharded(eight_devices):
    """The flax leaves ``cl_tpu``'s ``param_specs`` shards on its 2 × 4 mesh."""
    import jax

    from cl_tpu import sharding as jax_sharding

    params = export_jax_variables(_model())["params"]
    mesh = jax_sharding.make_mesh_2d(4, devices=eight_devices)
    specs = jax_sharding.param_specs(params, mesh, min_channels=MIN_CHANNELS)
    return {tuple(k.key for k in path) for path, s in jax.tree_util.tree_leaves_with_path(specs)
            if s.spec != jax.sharding.PartitionSpec()}


def test_param_specs_match_cl_tpu(group8, cl_tpu_sharded):
    got = {_flax_path(n) for n in group8[0]["sharded"]}
    assert got == cl_tpu_sharded and len(got) > 0
    model = _model()
    assert len(group8[0]["sharded"]) + len(group8[0]["replicated"]) == \
        len(list(model.parameters()))
    for r in range(8):
        assert group8[r]["sharded"] == group8[0]["sharded"]


def test_shards_hold_a_quarter_of_the_channels(group8):
    shapes = {n: tuple(p.shape) for n, p in _model().named_parameters()}
    for res in group8:
        for name, shape in shapes.items():
            want = list(shape)
            if name in res["sharded"]:
                want[res["sharded"][name]] //= 4
            assert res["local"][name] == tuple(want), name


def test_one_d_mesh_replicates_everything(group8):
    assert all(res["flat"] for res in group8)


def test_forward_from_shards_equals_replicated(group8):
    with torch.no_grad():
        ref = _model()(torch.from_numpy(_images())).numpy()
    for res in group8:
        np.testing.assert_allclose(res["out"].numpy(), ref[res["rows"]], atol=1e-4)
    assert {res["rows"].start for res in group8} == {0, 2}


@pytest.mark.parametrize("model,world", [(3, 8), (5, 4)])
def test_make_mesh_2d_rejects_indivisible(model, world):
    with pytest.raises(ValueError, match="not divisible"):
        sharding.make_mesh_2d(model, world=world, device_type="cpu")
