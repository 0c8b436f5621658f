"""Rank functions the multi-process port tests hand to
``theanompi_tpu_torch.launch.session.spawn_ranks``. Each runs in a fresh
process as one rank of a gloo process group, so this module imports the
port only (no JAX: the spawned ranks start quickly and stay lean) and
returns numpy arrays, never tensors."""

import torch

from theanompi_tpu_torch import bridge
from theanompi_tpu_torch import nn as tnn
from theanompi_tpu_torch.models.alex_net import AlexNet
from theanompi_tpu_torch.models.contract import Model, Recipe
from theanompi_tpu_torch.nn import init as initializers
from theanompi_tpu_torch.tree import tree_map

# every strategy/codec pairing the strategy parity tests hold against
# the reference: name -> (strategy, wire codec)
STRATEGY_CASES = {
    "psum": ("psum", None),
    "psum_bf16": ("psum_bf16", None),
    "ring": ("ring", None),
    "ring_bf16": ("ring_bf16", None),
    "ring_int8": ("ring_int8", None),
    "ring+int8": ("ring", "int8"),
    "psum+int8": ("psum", "int8"),
    "psum+int8:ef": ("psum", "int8:ef"),
}


class AlexNetNoDropout(AlexNet):
    """AlexNet with every Dropout rate 0: the parity runs compare
    trajectories, and dropout bits cannot match JAX's."""

    def build(self):
        net = super().build()
        for layer in net.layers:
            if isinstance(layer, tnn.Dropout):
                layer.rate = 0.0
        return net


class TinyCNN(Model):
    """The port's twin of ``tests/tinymodel.py::TinyCNN``: conv 8 + relu +
    2x2 max pool + dense, the cheapest model with a real loss."""

    name = "tinycnn"

    @classmethod
    def default_recipe(cls) -> Recipe:
        return Recipe(batch_size=16, optimizer="momentum",
                      opt_kwargs={"momentum": 0.9, "weight_decay": 1e-4},
                      schedule="step",
                      sched_kwargs={"lr": 0.05, "boundaries": [10 ** 9], "factor": 0.1},
                      input_shape=(16, 16, 3), num_classes=10)

    def build(self):
        he = initializers.he_normal()
        return tnn.Sequential([
            tnn.Conv(8, 3, padding="SAME", w_init=he, name="conv1"),
            tnn.Activation("relu"),
            tnn.Pool(2, stride=2, mode="max"),
            tnn.Flatten(),
            tnn.Dense(self.recipe.num_classes, name="softmax"),
        ], name="tiny_cnn")


def _tree_np(tree):
    return bridge.tree_to_jax(tree)


def strategies_rank(rank, n, device, grads_np, ef_np):
    """Every STRATEGY_CASES exchange of this rank's grads (the reference
    layout, converted) -> ``{case: synced grads (, ef')}`` as numpy."""
    from theanompi_tpu_torch.parallel.distributed import (
        assert_same_across_processes,
        is_multiprocess,
    )
    from theanompi_tpu_torch.parallel.strategies import get_strategy

    torch.set_num_threads(1)
    assert_same_across_processes(1.5, "a value every rank holds")
    try:
        assert_same_across_processes(float(rank), "the rank")
        caught = False
    except AssertionError:
        caught = True
    out = {"_distributed": {"multiprocess": is_multiprocess(), "caught_difference": caught}}
    for case, (name, codec) in STRATEGY_CASES.items():
        grads = bridge.tree_from_jax(grads_np[rank])
        strat = get_strategy(name, n, codec=codec, layouts=bridge.default_layouts)
        if getattr(strat, "stateful", False):
            ef = bridge.tree_from_jax(ef_np[rank]) if codec.endswith(":ef") else ()
            synced, ef = strat(grads, ef)
            out[case] = (_tree_np(synced), _tree_np(ef) if ef != () else ())
        else:
            out[case] = (_tree_np(strat(grads)), ())
    return out


# the LM cases of the layout parity: trees with a 4-D leaf (qkv) that is
# no conv kernel, exchanged with the LM's own layout tags
LM_STRATEGY_CASES = {
    "ring_int8": ("ring_int8", None),
    "psum+int8:ef": ("psum", "int8:ef"),
}


def lm_strategies_rank(rank, n, device, grads_np, ef_np):
    """The LM_STRATEGY_CASES exchanges of this rank's LM-shaped grads,
    built as ``BSPEngine`` builds them (``layouts=model.param_layouts``)
    -> ``{case: (synced grads, ef' or ())}`` as numpy, plus each synced
    leaf's shape. The LM holds every leaf in the reference's shape, so
    the trees cross as they are (no bridge)."""
    from theanompi_tpu_torch.models.lm import TransformerLMModel
    from theanompi_tpu_torch.parallel.strategies import get_strategy

    def to_torch(tree):
        return tree_map(lambda a: torch.from_numpy(a.copy()), tree)

    def to_np(tree):
        return tree_map(lambda t: t.numpy(), tree)

    torch.set_num_threads(1)
    layouts = TransformerLMModel().param_layouts
    out = {}
    for case, (name, codec) in LM_STRATEGY_CASES.items():
        strat = get_strategy(name, n, codec=codec, layouts=layouts)
        if getattr(strat, "stateful", False):
            synced, ef = strat(to_torch(grads_np[rank]), to_torch(ef_np[rank]))
            out[case] = (to_np(synced), to_np(ef))
        else:
            synced = strat(to_torch(grads_np[rank]))
            out[case] = (to_np(synced), ())
        out["_shapes"] = tree_map(lambda t: tuple(t.shape), synced)
    return out


def bsp_rank(rank, n, device, params_np, vel_np, batches, strategy):
    """3 fused-update BSP steps of the 67x67 no-dropout AlexNet (fp32)
    from the given weights on this rank's shard of each global batch ->
    losses, params and velocities (reference layout)."""
    from theanompi_tpu_torch.parallel.bsp import BSPEngine
    from theanompi_tpu_torch.parallel.mesh import host_local_batch_slice

    torch.set_num_threads(1)
    recipe = AlexNet.default_recipe().replace(
        input_shape=(67, 67, 3), num_classes=10, batch_size=len(batches[0][0]),
        compute_dtype=torch.float32)
    engine = BSPEngine(AlexNetNoDropout(recipe), n, device, fused_update=True,
                       strategy=strategy)
    state = engine.init_state(torch.Generator().manual_seed(0))
    state = state._replace(params=bridge.params_from_jax(params_np),
                           opt_state=bridge.opt_state_from_jax(vel_np))
    rows = host_local_batch_slice(len(batches[0][0]), rank, n)
    losses = []
    for x, y in batches:
        state, m = engine.train_step(state, torch.from_numpy(x[rows]),
                                     torch.from_numpy(y[rows]), None)
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": _tree_np(state.params),
            "vel": _tree_np(state.opt_state), "step": int(state.step)}


def resume_step_rank(rank, n, device, steps):
    """``agree_on_step`` with rank r holding ``steps[r]``; returns what
    every rank gathered when they agree (it raises on every rank when
    they do not)."""
    from theanompi_tpu_torch.parallel.distributed import agree_on_step, all_gather_objects

    agree_on_step(steps[rank], n)
    return all_gather_objects(steps[rank], n)


def fail_or_block_rank(rank, n, device):
    """Rank 0 fails at once; every other rank stays blocked (as a peer
    does in a collective that never returns) and never reports."""
    import time

    if rank == 0:
        e = RuntimeError("rank 0 fails")
        e.t_fail = time.time()
        raise e
    time.sleep(600)
