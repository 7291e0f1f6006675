"""Replay in the port against ``cl_tpu``'s, on the CPU.

The host buffer (``methods.replay.ReplayBuffer``) and the device-resident
one (``kernels.replay_gather.DeviceReplayBuffer``, #20's plain version on
the CPU) against ``cl_tpu``'s, bit for bit: the slots after reservoir
sampling past capacity, the samples, the flips, ``_device_replay_mix`` on
an empty buffer (task 0) and on a filled one; each buffer loads the other
format's ``state_dict`` and samples on as ``cl_tpu``'s does. The gather at
any row length. A 2-task ``train()`` with EWC and replay, host and device
buffer, against ``cl_tpu.train.train`` from the same ``init_variables``:
final per-task mIoU within 0.5 points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_tpu import train as jax_train
from cl_tpu.config import parse_overrides as jax_parse
from cl_tpu.data import pipeline as jax_pipeline
from cl_tpu.methods import ewc as jax_ewc
from cl_tpu.methods.replay import ReplayBuffer as JaxReplayBuffer
from cl_tpu.pallas.replay_gather import DeviceReplayBuffer as JaxDeviceReplayBuffer
from cl_tpu_torch import train as port_train
from cl_tpu_torch.config import parse_overrides
from cl_tpu_torch.data import pipeline
from cl_tpu_torch.interop import export_jax_variables
from cl_tpu_torch.kernels import replay_gather
from cl_tpu_torch.kernels.replay_gather import DeviceReplayBuffer
from cl_tpu_torch.methods.replay import ReplayBuffer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
ARGS = ["preset=smoke", "data.num_classes=3", "train.data_parallel=false", "train.num_tasks=2"]
CAP, SEED = 5, 1234


@pytest.fixture(scope="module")
def datasets():
    cfg = parse_overrides(ARGS)
    return [pipeline.make_datasets(cfg, t)[0] for t in (0, 1)], cfg.data.source_size


def _fill(buf, datasets):
    """Task 0's 4 images, then task 1's 4: past capacity 5, so reservoir
    draws replace slots."""
    for t, ds in enumerate(datasets):
        buf.add_examples(ds, 4, task_id=t)
    return buf


def _same_rng(a, b):
    sa, sb = a.get_state(), b.get_state()
    assert sa[0] == sb[0] and sa[2:] == sb[2:]
    np.testing.assert_array_equal(sa[1], sb[1])


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same_batch(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(_np(x), _np(y))


def test_host_buffer_matches_cl_tpu(datasets):
    dss, _ = datasets
    got, want = _fill(ReplayBuffer(CAP, seed=SEED), dss), _fill(JaxReplayBuffer(CAP, seed=SEED), dss)
    assert len(got) == len(want) == CAP and got._seen == want._seen == 8
    assert got.task_ids == want.task_ids and set(got.task_ids) == {0, 1}
    for a, b in zip(got.images + got.masks, want.images + want.masks):
        np.testing.assert_array_equal(a, b)
    _same_rng(got.rng, want.rng)
    for _ in range(3):
        _same_batch(got.sample(3, flip_prob=0.5), want.sample(3, flip_prob=0.5))
    fresh = next(iter(pipeline.batches(dss[1], batch_size=4, epoch=0, seed=0, shuffle=True,
                                       flip_prob=0.5)))
    _same_batch(pipeline.replay_mix(fresh, got.sample_or_current(2, fresh, flip_prob=0.5)),
                jax_pipeline.replay_mix(fresh, want.sample_or_current(2, fresh, flip_prob=0.5)))
    _same_rng(got.rng, want.rng)


def test_host_buffer_empty_samples_the_current_batch(datasets):
    dss, _ = datasets
    fresh = next(iter(pipeline.batches(dss[0], batch_size=4, epoch=0, seed=0, shuffle=True,
                                       flip_prob=0.5)))
    got = ReplayBuffer(CAP, seed=SEED).sample_or_current(3, fresh, flip_prob=0.5)
    want = JaxReplayBuffer(CAP, seed=SEED).sample_or_current(3, fresh, flip_prob=0.5)
    _same_batch(got, want)


def test_device_buffer_matches_cl_tpu(datasets):
    dss, S = datasets
    got = _fill(DeviceReplayBuffer(CAP, S, seed=SEED, device=CPU), dss)
    want = _fill(JaxDeviceReplayBuffer(CAP, S, seed=SEED), dss)
    assert got.count == want.count == CAP and got._seen == want._seen
    np.testing.assert_array_equal(got.images.numpy(), np.asarray(want.images))
    np.testing.assert_array_equal(got.masks.numpy(), np.asarray(want.masks))
    for _ in range(3):
        gi, wi = got.sample_indices(2), want.sample_indices(2)
        assert gi.dtype == torch.int32
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        _same_batch(got.gather(gi), want.gather(wi))
        np.testing.assert_array_equal(got.sample_flips(2, 0.5).numpy(),
                                      np.asarray(want.sample_flips(2, 0.5)))
    _same_rng(got.rng, want.rng)


def test_device_buffer_masks_start_as_ignore():
    buf = DeviceReplayBuffer(3, 8, seed=0, device=CPU)
    assert buf.sample_indices(2) is None and len(buf) == 0
    assert (buf.masks == 255).all() and (buf.images == 0).all()


@pytest.mark.parametrize("filled", [False, True], ids=["task0_empty", "filled"])
def test_device_replay_mix_matches_cl_tpu(datasets, filled):
    dss, S = datasets
    got = DeviceReplayBuffer(CAP, S, seed=SEED, device=CPU)
    want = JaxDeviceReplayBuffer(CAP, S, seed=SEED)
    if filled:
        _fill(got, dss)
        _fill(want, dss)
    hb = next(iter(pipeline.batches(dss[1], batch_size=4, epoch=0, seed=0, shuffle=True,
                                    flip_prob=0.5)))
    for _ in range(2):
        g = port_train._device_replay_mix(got, pipeline.put_batch(hb, CPU), 3, flip_prob=0.5)
        w = jax_train._device_replay_mix(
            want, jax_pipeline.HostBatch(*(jnp.asarray(a) for a in hb)), 3, flip_prob=0.5)
        assert g.image.shape[0] == 7
        _same_batch(g, w)
    _same_rng(got.rng, want.rng)


def _next_sample(buf):
    if isinstance(buf, (ReplayBuffer, JaxReplayBuffer)):
        return buf.sample(3, flip_prob=0.5)
    idx = buf.sample_indices(3)
    return (*buf.gather(idx), buf.sample_flips(3, 0.5))


@pytest.mark.parametrize("src,dst", [
    ("port_host", "cl_tpu_device"), ("port_host", "port_device"),
    ("port_device", "cl_tpu_host"), ("port_device", "port_host"),
    ("cl_tpu_host", "port_device"), ("cl_tpu_device", "port_host"),
])
def test_state_dict_loads_across_formats(datasets, src, dst):
    """A buffer restored from the other format's checkpoint samples on
    exactly as the buffer that wrote it."""
    dss, S = datasets
    make = {"port_host": lambda: ReplayBuffer(CAP, seed=0),
            "cl_tpu_host": lambda: JaxReplayBuffer(CAP, seed=0),
            "port_device": lambda: DeviceReplayBuffer(CAP, S, seed=0, device=CPU),
            "cl_tpu_device": lambda: JaxDeviceReplayBuffer(CAP, S, seed=0)}
    writer = make[src]()
    writer.add_examples(dss[0], 3, task_id=0)  # under capacity: the live rows only
    reader = make[dst]()
    reader.load_state_dict(writer.state_dict())
    assert len(reader) == len(writer) == 3
    _same_batch(_next_sample(reader), _next_sample(writer))


@pytest.mark.parametrize("shape", [(6, 37, 37, 3), (5, 40, 40), (4, 7), (3, 16)])
def test_gather_any_row_length(shape):
    rng = np.random.RandomState(0)
    buf = rng.randint(0, 256, size=shape).astype(np.uint8)
    idx = np.array([2, 0, 2, 1], np.int32)
    got = replay_gather.gather(torch.from_numpy(buf), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), buf[idx])


# ---------------------------------------------------------------------------
# A 2-task train() with EWC and replay against cl_tpu.train.train
# ---------------------------------------------------------------------------


TRAIN_ARGS = ARGS + ["method.methods=ewc,replay", "method.replay_batch=2",
                     "method.ewc_lambda=1000"]


@pytest.fixture(scope="module")
def jax_replay_train():
    """``(variables, cl_tpu.train.train's report)`` of the 2-task EWC +
    replay run with the host buffer, computed once for both buffers of the
    port: ``cl_tpu``'s device-resident buffer makes the same RandomState
    calls and gathers the same rows (``test_device_buffer_matches_cl_tpu``),
    so its run is the host buffer's."""
    cfg = parse_overrides(TRAIN_ARGS)
    variables = export_jax_variables(
        port_train.init_state(cfg, port_train.build_model(cfg), CPU))

    def injected_init_state(cfg_, model, tx):
        # cl_tpu's train() replaces the fresh init by init_variables at
        # once; skipping flax's own init saves seconds of CPU compile.
        jvars = jax.tree.map(jnp.asarray, variables)
        params = jvars["params"]
        return jax_train.TrainState(
            step=jnp.int32(0), params=params,
            model_state={"batch_stats": jvars["batch_stats"]},
            opt_state=tx.init(params),
            ewc=jax_ewc.make_ewc_state(params, mode="online"), lwf=None,
            rng=jax.random.PRNGKey(cfg_.train.seed))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_train, "init_state", injected_init_state)
        return variables, jax_train.train(jax_parse(TRAIN_ARGS + [
            "method.replay_device_resident=false"]), init_variables=variables)


@pytest.mark.parametrize("resident", ["false", "true"])
def test_two_task_ewc_replay_train_matches_jax(monkeypatch, jax_replay_train, resident):
    args = TRAIN_ARGS + [f"method.replay_device_resident={resident}"]
    cfg = parse_overrides(args)
    variables, want = jax_replay_train
    fisher_passes, fills = [], []
    real_fisher, real_mix = port_train.run_fisher_pass, port_train._device_replay_mix
    monkeypatch.setattr(port_train, "run_fisher_pass",
                        lambda *a: fisher_passes.append(a[3]) or real_fisher(*a))
    monkeypatch.setattr(port_train, "_device_replay_mix",
                        lambda *a, **k: fills.append(1) or real_mix(*a, **k))
    got = port_train.train(cfg, init_variables=variables, device="cpu")

    assert fisher_passes == [0]  # after task 0 only
    steps = cfg.train.num_tasks * cfg.data.train_images_per_task // cfg.data.batch_size
    assert len(fills) == (steps if resident == "true" else 0)
    assert got["config_hash"] == jax_parse(args).config_hash()
    final = np.asarray(got["final_per_task_miou"])
    assert final.shape == (2,) and np.all(np.isfinite(final))
    np.testing.assert_allclose(final, want["final_per_task_miou"], atol=0.005)
    assert np.all(np.isfinite(got["forgetting_per_task"]))
