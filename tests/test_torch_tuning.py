"""``cl_tpu``'s four route-only tuning variables in the port
(``CL_TPU_CONV_BUDGET``, ``CL_TPU_BWDF_BUDGET``, ``CL_TPU_ROW_TARGET``,
``CL_TPU_CAT_DOTS``; ``models/packed_gate.py``).

* The gates' decisions equal ``cl_tpu``'s over the grid CONV_BUDGET ∈ {8,
  16, 20, 22, 64} MiB × ROW_TARGET ∈ {1024, 4096, 8192, 16384} ×
  BWDF_BUDGET ∈ {14, 64} MiB × FUSE_BWD ∈ {0, 1}: ``packed_prefix`` (bf16
  and f32), ``double_conv_route`` (``conv_impl=v3`` and ``auto``) at every
  level of the five presets and of the headline (512², base 32, bf16), and
  ``conv_bwd_branch`` at every packed conv of each; ``cl_tpu``'s from its
  own functions (``packed_prefix``, ``packed_level_geometry``,
  ``conv3x3_v3.supported / profitable``, ``_cbf_bwd``'s pickers) with its
  module globals patched (it reads them at call time), the port's with its
  module attributes patched and no cache cleared (the cached gates key on
  them).
* The import-time parse in a subprocess with the environment set; a
  value ``int()`` cannot parse, and ``CL_TPU_CAT_DOTS=2``, raise
  ``ValueError`` with ``cl_tpu``'s message from ``check_supported``, not at
  import (``python -m cl_tpu_torch.cli --help`` still runs).
* One SGD step of ``preset=baseline_1 model.packed_min_size=0`` (128²,
  f32, batch 8) at an 8 MiB budget, where 2 levels run
  packed, against ``cl_tpu``'s ``make_train_step`` under the same patch:
  loss, params and batch stats within 1e-4, each update within 1e-2 of
  its norm plus one f32 ulp (``tests/test_torch_packed_train.py``'s).
"""

import itertools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_tpu import train as jax_train
from cl_tpu.config import parse_overrides as jax_parse
from cl_tpu.data import pipeline as jax_pipeline
from cl_tpu.models import unet as junet
from cl_tpu.pallas import conv3x3 as jconv2
from cl_tpu.pallas import conv3x3_v3 as jconv
from cl_tpu_torch import train as port_train
from cl_tpu_torch.config import get_preset, parse_overrides
from cl_tpu_torch.data import pipeline
from cl_tpu_torch.data import tasks as task_lib
from cl_tpu_torch.interop import export_jax_variables
from cl_tpu_torch.models import packed_gate
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
MIB = 1024 * 1024
GRID = list(itertools.product((8, 16, 20, 22, 64), (1024, 4096, 8192, 16384), (14, 64),
                              (False, True)))
# (image, base, depth, itemsize): the five presets and the headline
CONFIGS = sorted({(c.data.image_size, c.model.base_channels, c.model.depth,
                   2 if c.train.compute_dtype == "bfloat16" else 4)
                  for c in map(get_preset, [f"baseline_{i}" for i in range(1, 6)])}
                 | {(512, 32, 4, 2)})
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _patch(monkeypatch, conv, row, bwdf, fuse):
    for mod, names in ((packed_gate, ("CONV_VMEM_BUDGET", "CONV_ROW_TARGET",
                                      "FUSED_VMEM_BUDGET", "FUSE_BWD")),
                       (jconv, ("_VMEM_BUDGET", "_ROW_TARGET", "_VMEM_BUDGET_FUSED",
                                "_FUSE_BWD"))):
        for name, value in zip(names, (conv * MIB, row, bwdf * MIB, fuse)):
            monkeypatch.setattr(mod, name, value)


def _jax_route(h, c_in, feats, impl):
    """``cl_tpu``'s DoubleConv routes (``unet.py:314-349``, ``:102-130``)
    for a BatchNorm level at h × h."""
    if junet.packed_level_geometry(h, h, c_in, feats, impl) is not None:
        return "packed", "packed"
    ok = jconv.profitable if impl == "auto" else jconv.supported
    return tuple("v3" if ok(h, h, ci, feats) else "xla" for ci in (c_in, feats))


def _jax_branch(h, c_in, c_out, p, itemsize, prologue):
    """The branch ``_cbf_bwd`` takes (``conv3x3_v3.py:930-961``)."""
    wg = h // p
    lanes, lanes_x = p * c_out, p * c_in
    kdx, kdw = (p + 2) * c_out, (p + 2) * c_in
    if jconv._FUSE_BWD and jconv._pick_th_bwdf(h, wg, lanes, lanes_x, kdx, kdw, itemsize,
                                               prologue) > 0:
        return "one_pass"
    th = jconv._pick_th_dx(h, wg, lanes, kdx, lanes_x, itemsize, prologue)
    th_dw2 = jconv._pick_th_dw2(h, wg, lanes_x, kdw, p, c_out, itemsize)
    return "fused" if th > 0 and th_dw2 > 0 else "two_pass"


def _packed_convs(image, base, depth):
    """(H, Cin of the packed view, Cout, prologue) of every conv of the
    packed body if all ``depth`` levels ran packed (the stem's 3 channels
    viewed at 128 / P)."""
    P = packed_gate.pick_pack(base, base)
    convs = []
    for level in range(depth):
        h, f = image >> level, base << level
        convs += [(h, 128 // P if level == 0 else f // 2, f, False), (h, f, f, True),
                  (h, f, f, False)]
    return P, convs


@pytest.mark.parametrize("conv,row,bwdf,fuse", GRID,
                         ids=[f"conv{c}-row{r}-bwdf{b}-fuse{int(f)}" for c, r, b, f in GRID])
def test_gates_match_cl_tpu(conv, row, bwdf, fuse, monkeypatch):
    _patch(monkeypatch, conv, row, bwdf, fuse)
    for image, base, depth, itemsize in CONFIGS:
        for isz in (2, 4):
            assert packed_gate.packed_prefix(image, base, depth, isz) == \
                junet.packed_prefix(image, base, depth, isz), (image, base, isz)
        for name, h, ci, f in packed_gate.standard_body_levels(image, base, depth):
            for impl in ("v3", "auto"):
                assert packed_gate.double_conv_route(h, h, ci, f, impl, "batch") == \
                    _jax_route(h, ci, f, impl), (image, name, impl)
        P, convs = _packed_convs(image, base, depth)
        for h, ci, co, prologue in convs:
            assert packed_gate.conv_bwd_branch(h, h, ci, co, P, itemsize, prologue) == \
                _jax_branch(h, ci, co, P, itemsize, prologue), (h, ci, co, prologue)
    # the headline's prefix: 3 levels at the default, 4 from 22 MiB on
    if row == 8192:
        assert packed_gate.packed_prefix(512, 32, 4, 2) == (4 if conv >= 22 else 3)


def test_the_budget_moves_routes(monkeypatch):
    """22 MiB packs the headline's level 3 (64², 256 channels), whose prologue
    convs take the two-pass backward; 8 MiB leaves baseline_1's f32 128²
    body 2 packed levels."""
    _patch(monkeypatch, 22, 8192, 64, False)
    assert packed_gate.packed_prefix(512, 32, 4, 2) == 4
    assert [packed_gate.conv_bwd_branch(64, 64, ci, 256, 4, 2, pro)
            for ci, pro in ((128, False), (256, False), (256, True))] == \
        ["fused", "fused", "two_pass"]
    _patch(monkeypatch, 8, 8192, 64, False)
    assert packed_gate.packed_prefix(128, 32, 4, 4) == 2


def _run(code, **env):
    full = {k: v for k, v in os.environ.items() if not k.startswith("CL_TPU_")}
    full.update(env, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=full, cwd=ROOT, timeout=120)


def test_import_time_parse():
    out = _run("from cl_tpu_torch.models import packed_gate as g; "
               "print(g.CONV_VMEM_BUDGET, g.FUSED_VMEM_BUDGET, g.CONV_ROW_TARGET, g.CAT_DOTS, "
               "g.packed_prefix(512, 32, 4, 2), g.E_BF16)",
               CL_TPU_CONV_BUDGET="23068672", CL_TPU_BWDF_BUDGET=" 14680064 ",
               CL_TPU_ROW_TARGET="4096", CL_TPU_CAT_DOTS="0")
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["23068672", "14680064", "4096", "0", "4", "False"]


@pytest.mark.parametrize("env,match", [
    ({"CL_TPU_CAT_DOTS": "2"}, "CL_TPU_CAT_DOTS=2 unsupported"),
    ({"CL_TPU_CONV_BUDGET": "20MiB"}, "CL_TPU_CONV_BUDGET='20MiB' is not an integer"),
])
def test_bad_values_raise_at_check_not_import(env, match):
    code = ("from cl_tpu_torch import cli, train; from cl_tpu_torch.config import "
            "parse_overrides\nassert cli.main(['--help']) == 0\ntry:\n"
            "    train.check_supported(parse_overrides(['preset=smoke']), 'cpu')\n"
            "except ValueError as e:\n    print('RAISED', e)")
    out = _run(code, **env)
    assert out.returncode == 0, out.stderr
    assert f"RAISED {match}" in out.stdout, out.stdout


def test_cat_dots_message_is_cl_tpu_s():
    """The port's message for CL_TPU_CAT_DOTS=2 is the one ``cl_tpu``
    raises at the import of ``conv3x3_v3``."""
    out = _run("import cl_tpu.pallas.conv3x3_v3", CL_TPU_CAT_DOTS="2", JAX_PLATFORMS="cpu")
    assert out.returncode != 0
    want = out.stderr.strip().splitlines()[-1].split("ValueError: ", 1)[1]
    port = _run("from cl_tpu_torch.models import packed_gate as g\ntry:\n    g.check_tuning()\n"
                "except ValueError as e:\n    print(e)", CL_TPU_CAT_DOTS="2")
    assert port.stdout.strip() == want


@pytest.mark.parametrize("cat", [0, 1])
def test_cat_dots_zero_and_one_accepted(cat, monkeypatch):
    monkeypatch.setattr(packed_gate, "CAT_DOTS", cat)
    port_train.check_supported(parse_overrides(["preset=smoke"]), CPU)


STEP = ["preset=baseline_1", "model.packed_min_size=0",
        "train.optimizer=sgd", "train.lr=0.05", "train.data_parallel=false"]


@pytest.fixture(scope="module")
def budget_step():
    """One SGD step of baseline_1's packed body at an 8 MiB budget on both
    sides, from the same variables and batch."""
    mp = pytest.MonkeyPatch()
    try:
        _patch(mp, 8, 8192, 64, False)
        cfg, jcfg = parse_overrides(STEP), jax_parse(STEP)
        model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
        levels = model.packed_levels(128, 128)
        variables = export_jax_variables(model)
        step = port_train.make_train_step(cfg, model, port_train.build_optimizer(cfg, model),
                                          CPU)
        jmodel = jax_train.build_model(jcfg)
        tx = jax_train.build_optimizer(jcfg)
        params = jax.tree.map(jnp.asarray, variables["params"])
        state = jax_train.TrainState(
            step=jnp.int32(0), params=params,
            model_state={"batch_stats": jax.tree.map(jnp.asarray, variables["batch_stats"])},
            opt_state=tx.init(params), ewc=None, lwf=None, rng=jax.random.PRNGKey(0))
        hb = next(iter(pipeline.train_batches(cfg, 0, 0)))
        valid = task_lib.valid_class_mask(cfg.data.num_classes,
                                          task_lib.seen_classes(cfg.classes_per_task, 0))
        aux = step(pipeline.put_batch(hb, CPU), torch.from_numpy(valid))
        state, jaux = jax_train.make_train_step(jcfg, jmodel, tx, mesh=None)(
            state, jax_pipeline.HostBatch(*(jnp.asarray(a) for a in hb)), jnp.asarray(valid))
        jlevels = junet.packed_prefix(128, 32, 4, 4)
    finally:
        mp.undo()
    return {"levels": (levels, jlevels), "loss": (aux["loss"].item(), float(jaux["loss"])),
            "n_pix": (float(aux["n_pix"]), float(jaux["n_pix"])),
            "before": dict(jax.tree_util.tree_leaves_with_path(variables)),
            "got": dict(jax.tree_util.tree_leaves_with_path(export_jax_variables(model))),
            "want": jax.tree_util.tree_leaves_with_path(
                {"params": state.params, **state.model_state})}


def test_budget_step_matches_cl_tpu(budget_step):
    from test_torch_packed_head import check_step

    assert budget_step["levels"] == (2, 2)
    check_step(budget_step)


def test_unused_gen2_gate_ignores_the_row_target(monkeypatch):
    """The gen-2 conv's tile search starts at its own 2048 rows in both
    packages: ``CL_TPU_ROW_TARGET`` leaves ``g2_supported`` alone."""
    for row in (1024, 16384):
        _patch(monkeypatch, 20, row, 64, False)
        for h, ci, co in ((256, 64, 64), (16, 1024, 1024), (512, 32, 32), (128, 3, 32)):
            assert packed_gate.g2_supported(h, h, ci, co) == jconv2.supported(h, h, ci, co)
