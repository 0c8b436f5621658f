"""Rank functions of ``tests/test_torch_zoo_state.py`` for
``theanompi_tpu_torch.launch.session.spawn_ranks``: each runs in a fresh
process as one rank of a gloo process group, imports the port only (no
JAX) and returns numpy arrays."""

import torch

from theanompi_tpu_torch import bridge
from theanompi_tpu_torch.models.model_zoo.wrn import WRN_16_4
from theanompi_tpu_torch.tree import tree_leaves


def wrn_bsp_rank(rank, n, device, params_np, state_np, vel_np, batches, recipe_kw):
    """3 fused-update BSP steps of WRN-16-4 (Nesterov, BN) from the given
    weights, BN state and velocities on this rank's shard of each global
    batch -> losses, params, velocities and BN stats (reference layout)."""
    from theanompi_tpu_torch.parallel.bsp import BSPEngine
    from theanompi_tpu_torch.parallel.mesh import host_local_batch_slice

    torch.set_num_threads(1)
    model = WRN_16_4(WRN_16_4.default_recipe().replace(**recipe_kw))
    engine = BSPEngine(model, n, device, fused_update=True, strategy="psum")
    state = engine.init_state(torch.Generator().manual_seed(0))
    layouts = model.param_layouts(state.params)
    state = state._replace(params=bridge.params_from_jax(params_np, layouts=layouts),
                           model_state=bridge.tree_from_jax(state_np),
                           opt_state=bridge.tree_from_jax(vel_np, layouts={"vel": layouts}))
    rows = host_local_batch_slice(len(batches[0][0]), rank, n)
    losses = []
    for x, y in batches:
        state, m = engine.train_step(state, torch.from_numpy(x[rows]),
                                     torch.from_numpy(y[rows]), None)
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": bridge.params_to_jax(state.params, layouts),
            "vel": bridge.tree_to_jax(state.opt_state, {"vel": layouts}),
            "stats": [s.numpy() for s in tree_leaves(state.model_state)],
            "step": int(state.step)}
