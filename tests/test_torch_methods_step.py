"""One packed SGD step with all three methods, the port against ``cl_tpu``.

The headline step (the packed KD head, #11/#12's plain versions) with EWC
(#17/#18's plain versions; a perturbed anchor, a positive random Fisher,
weight 1, carried by ``interop.ewc_state_from_jax``), LwF (a perturbed
teacher with its own BatchNorm statistics, task 0's classes old) and a
batch widened by one replayed image (4 + 1, from a host buffer filled with
task 0's images), against ``cl_tpu.train.make_train_step`` with the same
injected EWC state and teacher: loss, the EWC penalty and the KD term
within 1e-4, params and batch stats within 1e-4, each leaf's update within
1e-2 of its norm plus one f32 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cl_tpu import train as jax_train
from cl_tpu.config import parse_overrides as jax_parse
from cl_tpu.data import pipeline as jax_pipeline
from cl_tpu.data import tasks as jax_tasks
from cl_tpu.methods import ewc as jax_ewc
from cl_tpu.methods import lwf as jax_lwf
from cl_tpu_torch import train as port_train
from cl_tpu_torch.config import parse_overrides
from cl_tpu_torch.data import pipeline
from cl_tpu_torch.interop import ewc_state_from_jax, export_jax_variables, load_jax_variables
from cl_tpu_torch.methods import lwf
from cl_tpu_torch.methods.replay import ReplayBuffer

from test_torch_ewc import PACKED, _ewc_trees
from test_torch_lwf import _teacher_variables
from test_torch_packed_head import check_step
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def methods_step():
    """One packed headline step with EWC (a perturbed anchor, a positive
    random Fisher, weight 1), LwF (a perturbed teacher, task 0's classes
    old) and a batch of 4 fresh and 1 replayed image, in the port and in
    ``cl_tpu``, each once."""
    args = PACKED + ["method.methods=ewc,lwf,replay", "method.replay_batch=1",
                     "train.optimizer=sgd", "train.lr=0.05"]
    cfg, jcfg = parse_overrides(args), jax_parse(args)
    assert port_train.packed_head_on(cfg)
    model = port_train.init_state(cfg, port_train.build_model(cfg), CPU)
    variables = export_jax_variables(model)
    tvars = _teacher_variables(variables, 11)
    anchor, fisher = _ewc_trees(variables["params"], 21, fisher_scale=1e-3)
    jewc = jax_ewc.EWCState(anchor=anchor, fisher=fisher, weight=np.float32(1.0),
                            n_tasks=np.int32(1))
    old_valid = jax_tasks.valid_class_mask(3, jax_tasks.seen_classes(jcfg.classes_per_task, 0))
    valid = jax_tasks.valid_class_mask(3, jax_tasks.seen_classes(jcfg.classes_per_task, 1))

    buf = ReplayBuffer(8, seed=cfg.data.shuffle_seed + 999)
    buf.add_examples(pipeline.make_datasets(cfg, 0)[0], 4, task_id=0)
    fresh = next(iter(pipeline.train_batches(cfg, 1, 0)))
    hb = pipeline.replay_mix(fresh, buf.sample_or_current(1, fresh, flip_prob=0.5))
    assert hb.image.shape[0] == 5

    st_l = lwf.make_lwf_state(model)
    load_jax_variables(st_l.teacher, tvars)
    st_l.old_valid.copy_(torch.from_numpy(old_valid))
    st_l.weight = 1.0
    st_e = ewc_state_from_jax(model, jewc, mode="online")
    step = port_train.make_train_step(cfg, model, port_train.build_optimizer(cfg, model), CPU,
                                      lwf=st_l, ewc=st_e)
    aux = step(pipeline.put_batch(hb, CPU), torch.from_numpy(valid))

    jmodel = jax_train.build_model(jcfg)
    tx = jax_train.build_optimizer(jcfg)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jl = jax_lwf.LwFState(
        old_params=jax.tree.map(jnp.asarray, tvars["params"]),
        old_model_state={"batch_stats": jax.tree.map(jnp.asarray, tvars["batch_stats"])},
        old_valid=jnp.asarray(old_valid), weight=jnp.float32(1.0))
    state = jax_train.TrainState(
        step=jnp.int32(0), params=params,
        model_state={"batch_stats": jax.tree.map(jnp.asarray, variables["batch_stats"])},
        opt_state=tx.init(params), ewc=jax.tree.map(jnp.asarray, jewc), lwf=jl,
        rng=jax.random.PRNGKey(0))
    state, jaux = jax_train.make_train_step(jcfg, jmodel, tx, mesh=None)(
        state, jax_pipeline.HostBatch(*(jnp.asarray(a) for a in hb)), jnp.asarray(valid))
    return {"loss": (aux["loss"].item(), float(jaux["loss"])),
            "ewc_penalty": (aux["ewc_penalty"].item(), float(jaux["ewc_penalty"])),
            "kd": (aux["kd"].item(), float(jaux["kd"])),
            "n_pix": (float(aux["n_pix"]), float(jaux["n_pix"])),
            "before": dict(jax.tree_util.tree_leaves_with_path(variables)),
            "got": dict(jax.tree_util.tree_leaves_with_path(export_jax_variables(model))),
            "want": jax.tree_util.tree_leaves_with_path(
                {"params": state.params, **state.model_state})}


def test_methods_step_terms(methods_step):
    for key in ("ewc_penalty", "kd"):
        got, want = methods_step[key]
        assert want > 0, key
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=key)


def test_methods_step_matches_cl_tpu(methods_step):
    check_step(methods_step)
