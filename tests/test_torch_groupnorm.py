"""GroupNorm in the port (``model.norm=group``) against ``cl_tpu``'s flax
``nn.GroupNorm`` model path.

Inputs come from a numpy seed; the weights are the port's seeded init with
every GroupNorm scale and bias moved, carried to flax by
``interop.export_jax_variables``. Checks: the ``GroupNorm`` module against
``flax.linen.GroupNorm`` (f32 within 1e-5; bf16 input within one bf16 ulp,
the same rounded operand); ``DoubleConv`` and a ``UNet(norm="group")``
forward (base 8, depth 3, 32²) against ``cl_tpu``'s (f32 logits within
1e-4; bf16 within one bf16 ulp of the value plus the f32 floor, 1e-4, for
the DoubleConv, and the UNet's bf16 logits within one bf16 ulp of the
logits' largest magnitude plus the f32 floor: a bf16 rounding that flips
deep in the net moves every later layer, so a small logit may lie many of
its own ulps away while no logit moves by more than one rounding of the
head's output at the logits' scale); the interop round
trip with ``gn*`` leaves; one SGD step of ``preset=smoke
model.norm=group`` and of a ``model.conv_impl=v3`` UNet (32², base 32,
depth 1, where ``cl_tpu`` routes four convs through its gen-3 kernel, run
here in interpret mode) against ``cl_tpu``'s ``make_train_step``: loss and
every param within 1e-4, each update within 1e-2 of its norm plus one f32
ulp. Each ``cl_tpu`` output is computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_tpu import train as jax_train
from cl_tpu.config import parse_overrides as jax_parse
from cl_tpu.data import pipeline as jax_pipeline
from cl_tpu.models import unet as jax_unet
from cl_tpu_torch import train as port_train
from cl_tpu_torch.config import parse_overrides
from cl_tpu_torch.data import pipeline
from cl_tpu_torch.data import tasks as task_lib
from cl_tpu_torch.interop import export_jax_variables, load_jax_variables
from cl_tpu_torch.models import packed_gate
from cl_tpu_torch.models.unet import DoubleConv, GroupNorm, UNet, init_weights
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
NUM_CLASSES, BASE, DEPTH = 3, 8, 3


def _bf16_ulp(x):
    x = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(x)) - 7)


def _moved(variables, seed):
    """``variables`` with every GroupNorm scale and bias moved by seeded
    noise, so the affine part is not the identity."""
    rng = np.random.RandomState(seed)

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        a = np.array(tree, np.float32)
        if any(p.startswith("gn") for p in path):
            a = a + rng.randn(*a.shape).astype(np.float32) * 0.3
        return a

    return walk(variables)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [8, 32, 6])
def test_group_norm_matches_flax(c, dtype):
    """The module against ``flax.linen.GroupNorm(num_groups=min(8, C))`` with
    the model's settings, on a shifted input (E[x]² large beside the
    variance: the fast variance's rounding shows)."""
    import flax.linen as fnn

    rng = np.random.RandomState(c)
    x = (rng.randn(2, 6, 5, c) * 2 + 3).astype(np.float32)
    scale = (1 + rng.randn(c) * 0.3).astype(np.float32)
    bias = (rng.randn(c) * 0.3).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx = jnp.asarray(x).astype(jdt)
    want = np.asarray(fnn.GroupNorm(num_groups=min(8, c), dtype=jdt, param_dtype=jnp.float32)
                      .apply({"params": {"scale": scale, "bias": bias}}, jx), np.float32)
    gn = GroupNorm(c)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(scale))
        gn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt).permute(0, 3, 1, 2)
    got = gn(xt.contiguous(memory_format=torch.channels_last))
    assert got.dtype == tdt
    got = _nhwc(got.detach())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.all(np.abs(got - want) <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_double_conv_matches_cl_tpu(dtype):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 16, 16, 8).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    port = DoubleConv(8, 16, norm="group")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for conv in (port.conv0, port.conv1):
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * 0.2)
        for gn in (port.gn0, port.gn1):
            gn.weight.copy_(1 + torch.randn(16, generator=g) * 0.3)
            gn.bias.copy_(torch.randn(16, generator=g) * 0.3)
    params = {f"conv{i}": {"kernel": getattr(port, f"conv{i}").weight.detach().numpy()
                           .transpose(2, 3, 1, 0)} for i in range(2)}
    for i in range(2):
        gn = getattr(port, f"gn{i}")
        params[f"gn{i}"] = {"scale": gn.weight.detach().numpy(), "bias": gn.bias.detach().numpy()}
    jx = jnp.asarray(x).astype(jdt)
    want = np.asarray(jax_unet.DoubleConv(16, norm="group", dtype=jdt).apply(
        {"params": params}, jx, train=True), np.float32)
    xt = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt).permute(0, 3, 1, 2)
    got = _nhwc(port(xt.contiguous(memory_format=torch.channels_last)).detach())
    assert got.shape == want.shape == (2, 16, 16, 16)
    tol = 1e-4 + (_bf16_ulp(np.maximum(np.abs(got), np.abs(want))) if dtype == "bfloat16"
                  else 1e-4 * np.abs(want))
    assert np.all(np.abs(got - want) <= tol), float(np.max(np.abs(got - want) - tol))


@pytest.fixture(scope="module")
def unet_pair():
    """The port's UNet(norm="group") and the flax variables carried from it,
    with GroupNorm scales and biases moved."""
    seeded = UNet(NUM_CLASSES, BASE, DEPTH, norm="group")
    init_weights(seeded, torch.Generator().manual_seed(0))
    variables = _moved(export_jax_variables(seeded), 2)
    assert "batch_stats" not in variables
    return variables


def test_interop_round_trip(unet_pair):
    model = UNet(NUM_CLASSES, BASE, DEPTH, norm="group").to(memory_format=torch.channels_last)
    load_jax_variables(model, unet_pair)
    assert {k for k in model.state_dict() if ".gn" in k} and \
        not {k for k in model.state_dict() if ".bn" in k}
    back = export_jax_variables(model)
    flat_a = jax.tree_util.tree_leaves_with_path(unet_pair)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    assert any("gn0" in jax.tree_util.keystr(p) for p, _ in flat_a)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unet_forward_matches_cl_tpu(unet_pair, dtype):
    x = np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jm = jax_unet.UNet(num_classes=NUM_CLASSES, base_channels=BASE, depth=DEPTH, norm="group",
                       dtype=jdt)
    want = np.asarray(jm.apply(unet_pair, jnp.asarray(x), train=True))
    model = UNet(NUM_CLASSES, BASE, DEPTH, norm="group", dtype=tdt).to(
        memory_format=torch.channels_last)
    load_jax_variables(model, unet_pair)
    with torch.no_grad():
        got = model.train()(torch.from_numpy(x)).numpy()
        got_eval = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 32, 32, NUM_CLASSES) and got.dtype == np.float32
    np.testing.assert_array_equal(got, got_eval)  # GroupNorm has no running state
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        tol = _bf16_ulp(np.abs(want).max()) + 1e-4
        assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


# ---------------------------------------------------------------------------
# One SGD step against cl_tpu's make_train_step
# ---------------------------------------------------------------------------

STEPS = {
    "xla": ["preset=smoke", "model.norm=group", "data.num_classes=3"],
    "v3": ["preset=smoke", "model.norm=group", "data.num_classes=3", "model.base_channels=32",
           "model.depth=1", "model.conv_impl=v3"],
}


def _step_pair(args):
    args = args + ["train.optimizer=sgd", "train.lr=0.05", "train.data_parallel=false"]
    cfg, jcfg = parse_overrides(args), jax_parse(args)
    port_train.check_supported(cfg, CPU)
    model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
    variables = _moved(export_jax_variables(model), 4)
    load_jax_variables(model, variables)
    step = port_train.make_train_step(cfg, model, port_train.build_optimizer(cfg, model), CPU)
    jmodel = jax_train.build_model(jcfg)
    assert jmodel.norm == "group" and model.norm == "group"
    tx = jax_train.build_optimizer(jcfg)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = jax_train.TrainState(step=jnp.int32(0), params=params, model_state={},
                                 opt_state=tx.init(params), ewc=None, lwf=None,
                                 rng=jax.random.PRNGKey(0))
    hb = next(iter(pipeline.train_batches(cfg, 0, 0)))
    valid = task_lib.valid_class_mask(3, task_lib.seen_classes(cfg.classes_per_task, 0))
    aux = step(pipeline.put_batch(hb, CPU), torch.from_numpy(valid))
    state, jaux = jax_train.make_train_step(jcfg, jmodel, tx, mesh=None)(
        state, jax_pipeline.HostBatch(*(jnp.asarray(a) for a in hb)), jnp.asarray(valid))
    return {"loss": (aux["loss"].item(), float(jaux["loss"])),
            "n_pix": (float(aux["n_pix"]), float(jaux["n_pix"])),
            "before": dict(jax.tree_util.tree_leaves_with_path(variables)),
            "got": dict(jax.tree_util.tree_leaves_with_path(export_jax_variables(model))),
            "want": jax.tree_util.tree_leaves_with_path({"params": state.params})}


@pytest.mark.parametrize("route", list(STEPS))
def test_train_step_matches_cl_tpu(route):
    from test_torch_packed_head import check_step

    if route == "v3":
        # the gen-3 conv takes enc0.conv1, the bottleneck's conv1 and both of
        # dec0's convs at this size; GroupNorm never takes the packed level
        assert [packed_gate.double_conv_route(h, h, ci, f, "v3", "group")
                for _, h, ci, f in packed_gate.standard_body_levels(32, 32, 1)] == [
            ("xla", "v3"), ("xla", "v3"), ("v3", "v3")]
    res = _step_pair(STEPS[route])
    check_step(res)
    assert any("gn1" in jax.tree_util.keystr(p) for p, _ in res["want"])
