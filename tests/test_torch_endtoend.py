"""End-to-end: the port's ``train()`` against ``cl_tpu.train.train`` on the
CPU, from the same initial weights (``init_variables``) and the same
seeded data stream. A smoke-sized run (32², UNet base 8, 2 steps, one
eval) must give per-task mIoU within 0.5 points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cl_tpu import train as jax_train
from cl_tpu.config import parse_overrides as jax_parse
from cl_tpu_torch import train as port_train
from cl_tpu_torch.config import parse_overrides
from cl_tpu_torch.interop import export_jax_variables

ARGS = ["preset=smoke", "data.num_classes=3", "train.data_parallel=false"]


def test_two_step_train_miou_matches_jax(monkeypatch):
    cfg, jcfg = parse_overrides(ARGS), jax_parse(ARGS)
    cpu = torch.device("cpu")
    variables = export_jax_variables(
        port_train.init_state(cfg, port_train.build_model(cfg), cpu))

    def injected_init_state(cfg_, model, tx):
        # cl_tpu's train() replaces the fresh init by init_variables at
        # once; skipping flax's own init saves seconds of CPU compile.
        params = jax.tree.map(jnp.asarray, variables["params"])
        return jax_train.TrainState(
            step=jnp.int32(0), params=params,
            model_state={"batch_stats": jax.tree.map(
                jnp.asarray, variables["batch_stats"])},
            opt_state=tx.init(params), ewc=None, lwf=None,
            rng=jax.random.PRNGKey(cfg_.train.seed))

    monkeypatch.setattr(jax_train, "init_state", injected_init_state)
    want = jax_train.train(jcfg, init_variables=variables)
    got = port_train.train(cfg, init_variables=variables, device="cpu")

    assert got["config_hash"] == want["config_hash"]
    assert got["device"] == "cpu"
    final = np.asarray(got["final_per_task_miou"])
    assert final.shape == (1,) and np.all(np.isfinite(final))
    np.testing.assert_allclose(final, want["final_per_task_miou"], atol=0.005)
