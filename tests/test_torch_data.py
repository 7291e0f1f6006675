"""The port's data path against ``cl_tpu``'s, on the CPU.

The native rasterizer (C++ and its Python reference) byte for byte against
``cl_tpu.native``; ``NativeSyntheticSegDataset`` and the directory loader
against ``cl_tpu``'s; the host pipeline's ``get_batch`` path; the device
cache's batches (with and without eval pad rows) against the host
pipeline and ``cl_tpu.data.cached_exec.gather_batch``; the replay plan in
both modes against ``cl_tpu``'s, the buffer's RandomState state after the
epoch included; zero-step epochs; the plan-driven Fisher pass against the
host one, bit for bit. Then ``train()``: ``data.device_cache`` on and off
give the same losses and mIoU bit for bit (EWC + LwF + replay, 2 tasks),
the ``hbm_live_set`` events, and the port's cached ``train()`` against
``cl_tpu.train.train``'s within 0.5 mIoU points.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cl_tpu.native as jax_native
from cl_tpu import train as jax_train
from cl_tpu.config import parse_overrides as jax_parse
from cl_tpu.data import cached_exec as jax_cached
from cl_tpu.data import directory as jax_directory
from cl_tpu.data import pipeline as jax_pipeline
from cl_tpu.data.synthetic_native import NativeSyntheticSegDataset as JaxNativeDataset
from cl_tpu.methods.replay import ReplayBuffer as JaxReplayBuffer
from cl_tpu.native import pyref as jax_pyref
from cl_tpu.pallas.replay_gather import DeviceReplayBuffer as JaxDeviceReplayBuffer
from cl_tpu_torch import native
from cl_tpu_torch import train as port_train
from cl_tpu_torch.config import parse_overrides
from cl_tpu_torch.data import cached_exec, directory, pipeline
from cl_tpu_torch.data.device_cache import DeviceDatasetCache
from cl_tpu_torch.data.synthetic_native import NativeSyntheticSegDataset
from cl_tpu_torch.interop import export_jax_variables
from cl_tpu_torch.kernels.replay_gather import DeviceReplayBuffer
from cl_tpu_torch.methods.replay import ReplayBuffer
from cl_tpu_torch.native import pyref
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = ["preset=smoke", "data.num_classes=5", "train.data_parallel=false",
          "data.dataset=synthetic_native", "model.depth=2"]


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same(a, b):
    for u, v in zip(a, b):
        np.testing.assert_array_equal(_np(u), _np(v))


def _same_rng(a, b):
    sa, sb = a.get_state(), b.get_state()
    assert sa[0] == sb[0] and sa[2:] == sb[2:]
    np.testing.assert_array_equal(sa[1], sb[1])


# ---------------------------------------------------------------------------
# The rasterizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["rasterizer.cpp", "pyref.py"])
def test_native_sources_are_copies(name):
    with open(os.path.join(ROOT, "cl_tpu", "native", name), "rb") as f:
        want = f.read()
    with open(os.path.join(ROOT, "cl_tpu_torch", "native", name), "rb") as f:
        assert f.read() == want


def test_the_cxx_library_builds_and_says_so():
    assert native.available() and native.backend() == "native"
    assert native.load_error() is None


@pytest.mark.parametrize("seed,index,size,classes", [
    (1, 0, 40, [1, 2, 3]), (7, 3, 64, [4]), (123, 5, 33, [1, 2, 3, 4, 5, 6]),
    (2024, 11, 576, [11, 12])])
def test_rasterizer_matches_cl_tpu(seed, index, size, classes):
    """The port's C++ library against ``cl_tpu``'s, and the port's Python
    reference against both (``cl_tpu``'s Python reference at the small
    sizes: it takes seconds an image at 576², and the sources are byte
    copies)."""
    got = native.rasterize(seed, index, size, classes)
    _same(got, jax_native.rasterize(seed, index, size, classes))
    _same(got, pyref.rasterize(seed, index, size, classes))
    if size < 100:
        _same(got, jax_pyref.rasterize(seed, index, size, classes))


def test_rasterize_batch_equals_single_calls():
    idx = [5, 0, 17, 3, 3]
    imgs, masks = native.rasterize_batch(9, idx, 48, [1, 2], n_threads=3)
    _same((imgs, masks), jax_native.rasterize_batch(9, idx, 48, [1, 2]))
    for k, i in enumerate(idx):
        _same((imgs[k], masks[k]), native.rasterize(9, i, 48, [1, 2]))


@pytest.mark.parametrize("split", ["train", "val"])
def test_native_dataset_matches_cl_tpu(split):
    kw = dict(num_images=6, size=40, task_classes=[2, 3], seed=11, split=split)
    got, want = NativeSyntheticSegDataset(**kw), JaxNativeDataset(**kw)
    assert got.seed == want.seed and got.backend == "native" and len(got) == 6
    for i in (0, 5):
        _same(got[i], want[i])
    idx = np.array([4, 1, 1])
    _same(got.get_batch(idx), want.get_batch(idx))
    _same(got.get_batch(idx), [np.stack(a) for a in zip(*(got[int(i)] for i in idx))])


def test_pipeline_batches_match_cl_tpu():
    """The host pipeline's ``get_batch`` path, with a padded eval batch."""
    cfg, jcfg = parse_overrides(NATIVE), jax_parse(NATIVE)
    got = list(pipeline.batches(pipeline.make_datasets(cfg, 0)[1], batch_size=3, epoch=0,
                                seed=5, shuffle=False, flip_prob=0.5, pad_final=True))
    want = list(jax_pipeline.batches(jax_pipeline.make_datasets(jcfg, 0)[1], batch_size=3,
                                     epoch=0, seed=5, shuffle=False, flip_prob=0.5,
                                     pad_final=True))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _same(g, w)
    assert (got[-1].mask[-2:] == 255).all()  # 4 val images: two pad rows


# ---------------------------------------------------------------------------
# The directory loader
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """images/{train,val} and masks/{train,val} with PNG and .npy files,
    square and non-square sources, one image without a task-0 class."""
    from PIL import Image

    root = tmp_path_factory.mktemp("voc")
    rng = np.random.RandomState(3)
    for split, n in (("train", 5), ("val", 3)):
        for sub in ("images", "masks"):
            os.makedirs(root / sub / split)
        for i in range(n):
            h, w = (40, 40) if i % 2 else (30, 52)
            img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            mask = rng.randint(0, 5, (h, w)).astype(np.uint8)
            if i == 3:
                mask[:] = 4  # no class of task 0
            mask[0, :3] = 255
            if i % 2:
                Image.fromarray(img).save(root / "images" / split / f"{i:03d}.png")
                Image.fromarray(mask).save(root / "masks" / split / f"{i:03d}.png")
            else:
                np.save(root / "images" / split / f"{i:03d}.npy", img)
                np.save(root / "masks" / split / f"{i:03d}.npy", mask)
    return str(root)


def test_directory_loader_matches_cl_tpu(data_dir):
    args = ["preset=smoke", "data.num_classes=5", "train.num_tasks=2", "data.dataset=voc_dir",
            f"data.data_dir={data_dir}", "data.train_images_per_task=4"]
    cfg, jcfg = parse_overrides(args), jax_parse(args)
    for task in (0, 1):
        got, want = pipeline.make_datasets(cfg, task), jax_pipeline.make_datasets(jcfg, task)
        for g, w in zip(got, want):
            assert isinstance(g, directory.DirectorySegDataset) and len(g) == len(w) > 0
            assert [os.path.basename(p) for p, _ in g.items] == \
                [os.path.basename(p) for p, _ in w.items]
            for i in range(len(g)):
                img, mask = g[i]
                assert img.shape == (40, 40, 3) and mask.shape == (40, 40)  # squashed
                _same((img, mask), w[i])
            _same(g.get_batch(np.arange(len(g))), w.get_batch(np.arange(len(w))))
    assert len(pipeline.make_datasets(cfg, 0)[0]) == 4  # the per-task cap
    assert len(jax_directory.make_datasets(jcfg, 0)[0]) == 4


# ---------------------------------------------------------------------------
# The device cache and the plan
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def native_ds():
    return NativeSyntheticSegDataset(num_images=10, size=40, task_classes=[1, 2], seed=4)


@pytest.mark.parametrize("pad_final", [False, True])
def test_device_cache_batches_match_host_and_cl_tpu(native_ds, pad_final):
    cache = DeviceDatasetCache(native_ds, CPU, chunk=4)
    assert cache.n == 10 and cache.nbytes() == 10 * 40 * 40 * 4
    kw = dict(batch_size=4, epoch=3, seed=8, shuffle=not pad_final,
              flip_prob=0.0 if pad_final else 0.5, pad_final=pad_final)
    host = list(pipeline.batches(native_ds, **kw))
    dev = list(cache.batches(**kw))
    jplan = jax_cached.build_plan(10, **kw)
    jimg, jmask = jnp.asarray(cache.images.numpy()), jnp.asarray(cache.masks.numpy())
    want = [jax_cached.gather_batch(jimg, jmask, (jplan.idx, jplan.flip, jplan.pad), s,
                                    ignore_index=255) for s in range(jplan.steps)]
    assert len(host) == len(dev) == len(want) == (3 if pad_final else 2)
    for h, d, w in zip(host, dev, want):
        _same(d, h)
        _same(d, w)
    if pad_final:
        assert (dev[-1].mask[2:] == 255).all() and (dev[-1].mask[:2] != 255).any()


def test_zero_step_epoch():
    plan = cached_exec.build_plan(3, batch_size=4, epoch=0, seed=1, shuffle=True,
                                  flip_prob=0.5, device=CPU)
    assert plan.steps == 0 and tuple(plan.idx.shape) == (0, 4) and plan.pad is None
    buf = ReplayBuffer(4, seed=2)
    for b in (buf, DeviceReplayBuffer(4, 40, seed=2, device=CPU)):
        mode, idx, flips = cached_exec.build_replay_plan(b, steps=0, k=2, batch_size=4,
                                                         flip_prob=0.5, device=CPU)
        assert mode == "batch" and tuple(idx.shape) == (0, 2) and flips is None
    buf.images.append(np.zeros((40, 40, 3), np.uint8))
    buf.masks.append(np.zeros((40, 40), np.uint8))
    mode, idx, flips = cached_exec.build_replay_plan(buf, steps=0, k=2, batch_size=4,
                                                     flip_prob=0.5, device=CPU)
    assert mode == "buffer" and tuple(idx.shape) == tuple(flips.shape) == (0, 2)


def test_dataset_smaller_than_the_batch_trains_zero_steps():
    cfg = parse_overrides(NATIVE + ["data.device_cache=true", "method.methods=replay",
                                    "data.train_images_per_task=3"])
    report = port_train.train(cfg, device="cpu")
    assert "images_per_sec_per_chip" not in report  # no step ran
    assert len(report["final_per_task_miou"]) == 1


@pytest.mark.parametrize("source", ["empty", "host", "device"])
def test_replay_plan_matches_cl_tpu(native_ds, source):
    """Both modes of the epoch's replay draws, and the buffer's RandomState
    after them; then step 1's widened batch in each mode."""
    mk = {"host": (ReplayBuffer, JaxReplayBuffer), "empty": (ReplayBuffer, JaxReplayBuffer),
          "device": (DeviceReplayBuffer, JaxDeviceReplayBuffer)}[source]
    bufs = []
    for cls in mk:
        buf = (cls(6, seed=31) if cls in (ReplayBuffer, JaxReplayBuffer)
               else cls(6, 40, seed=31, device=CPU) if cls is DeviceReplayBuffer
               else cls(6, 40, seed=31))
        if source != "empty":
            buf.add_examples(native_ds, 4, task_id=0)
        bufs.append(buf)
    got = cached_exec.build_replay_plan(bufs[0], steps=3, k=2, batch_size=4, flip_prob=0.5,
                                        device=CPU)
    want = jax_cached.build_replay_plan(bufs[1], steps=3, k=2, batch_size=4, flip_prob=0.5)
    assert got[0] == want[0] == ("batch" if source == "empty" else "buffer")
    assert (got[2] is None) == (want[2] is None)
    _same([g for g in got[1:] if g is not None], [w for w in want[1:] if w is not None])
    _same_rng(bufs[0].rng, bufs[1].rng)

    cache = DeviceDatasetCache(native_ds, CPU)
    plan = cached_exec.build_plan(10, batch_size=4, epoch=0, seed=3, shuffle=True,
                                  flip_prob=0.5, device=CPU)
    batch = cached_exec.gather_batch(cache.images, cache.masks, plan, 1)
    jbatch = jax_pipeline.HostBatch(*(jnp.asarray(_np(t)) for t in batch))
    rep = cached_exec.replay_arrays(bufs[0], CPU) if got[0] == "buffer" else (None, None)
    jrep = jax_cached.replay_arrays(bufs[1]) if got[0] == "buffer" else (None, None)
    if source == "host":
        assert rep[0].shape[0] == 6 and not rep[0][4:].any()  # zero-padded to capacity
    _same(cached_exec.widen_with_replay(batch, got[0], got[1], got[2], 1, *rep),
          jax_cached.widen_with_replay(jbatch, want[0], want[1], want[2], 1, *jrep))


def test_cached_fisher_pass_equals_the_host_pass():
    """``run_fisher_pass`` over the train cache and over the host pipeline:
    the same batches, the same bits."""
    cfg = parse_overrides(NATIVE + ["method.methods=ewc", "train.use_pallas=false",
                                    "method.ewc_fisher_batches=1"])
    model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
    step = port_train.make_fisher_step(cfg, model, CPU)
    seen = np.ones(cfg.data.num_classes, bool)
    cache = DeviceDatasetCache(pipeline.make_datasets(cfg, 0)[0], CPU)
    host = port_train.run_fisher_pass(cfg, step, model, 0, seen, CPU)
    cached = port_train.run_fisher_pass(cfg, step, model, 0, seen, CPU, cache=cache)
    assert host.abs().sum() > 0
    assert torch.equal(host, cached)


# ---------------------------------------------------------------------------
# train() with the device cache
# ---------------------------------------------------------------------------


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_cached_train_equals_host_train(tmp_path):
    """EWC + LwF + replay (host buffer), 2 tasks, the native dataset:
    ``data.device_cache`` on and off give the same epoch losses and mIoU
    matrix, bit for bit; each task boundary logs ``hbm_live_set`` with
    ``cl_tpu``'s keys, the train cache freed and no val cache left."""
    args = NATIVE + ["train.num_tasks=2", "method.methods=ewc,lwf,replay",
                     "train.use_pallas=false", "method.ewc_fisher_batches=1"]
    runs = {}
    for cached in ("false", "true"):
        log = str(tmp_path / f"{cached}.jsonl")
        report = port_train.train(parse_overrides(args + [f"data.device_cache={cached}",
                                                          f"train.log_path={log}"]),
                                  device="cpu")
        runs[cached] = (report, _events(log))
    (r0, e0), (r1, e1) = runs["false"], runs["true"]
    np.testing.assert_array_equal(np.asarray(r1["miou_matrix"]), np.asarray(r0["miou_matrix"]))
    losses = [[e["loss"] for e in ev if e["event"] == "epoch"] for ev in (e0, e1)]
    assert len(losses[0]) == 2 and losses[0] == losses[1]
    live = [e for e in e1 if e["event"] == "hbm_live_set"]
    keys = {"params_mb", "opt_state_mb", "model_state_mb", "ewc_mb", "lwf_teacher_mb",
            "train_cache_mb", "val_caches_mb", "val_caches_n", "replay_arrays_mb", "total_mb"}
    assert [e["task"] for e in live] == [0, 1]
    for e in live:
        assert keys <= set(e) and e["train_cache_mb"] == e["val_caches_mb"] == 0
        assert e["val_caches_n"] == 0 and e["params_mb"] > 0 and e["ewc_mb"] > 0
    assert live[0]["replay_arrays_mb"] == 0 and live[1]["replay_arrays_mb"] > 0


def test_cached_train_matches_cl_tpu(monkeypatch):
    """The port's ``train()`` and ``cl_tpu.train.train`` with
    ``data.device_cache=true`` (the native dataset, replay through the
    plan, ``cl_tpu``'s epoch as one ``lax.scan``), from the same weights:
    per-task mIoU within 0.5 points. The plain losses
    (``train.use_pallas=false``): the data path is under test, and
    ``cl_tpu``'s loss kernels in interpret mode would treble the time."""
    args = NATIVE + ["data.num_classes=3", "data.device_cache=true", "method.methods=replay",
                     "method.replay_batch=1", "train.use_pallas=false"]
    cfg, jcfg = parse_overrides(args), jax_parse(args)
    variables = export_jax_variables(port_train.init_state(cfg, port_train.build_model(cfg), CPU))

    def injected_init_state(cfg_, model, tx):
        # cl_tpu's train() replaces the fresh init by init_variables at
        # once; skipping flax's own init saves seconds of CPU compile.
        params = jax.tree.map(jnp.asarray, variables["params"])
        return jax_train.TrainState(
            step=jnp.int32(0), params=params,
            model_state={"batch_stats": jax.tree.map(jnp.asarray, variables["batch_stats"])},
            opt_state=tx.init(params), ewc=None, lwf=None,
            rng=jax.random.PRNGKey(cfg_.train.seed))

    monkeypatch.setattr(jax_train, "init_state", injected_init_state)
    want = jax_train.train(jcfg, init_variables=variables)
    got = port_train.train(cfg, init_variables=variables, device="cpu")
    assert got["config_hash"] == want["config_hash"]
    final = np.asarray(got["final_per_task_miou"])
    assert final.shape == (1,) and np.all(np.isfinite(final))
    np.testing.assert_allclose(final, want["final_per_task_miou"], atol=0.005)
