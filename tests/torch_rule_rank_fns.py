"""Rank functions of ``tests/test_torch_easgd.py``,
``tests/test_torch_gosgd.py`` and ``tests/test_torch_rule_groups.py`` for
``theanompi_tpu_torch.launch.session.spawn_ranks``: each runs in a fresh
process as one rank of a gloo process group, imports the port only (no
JAX) and returns numpy arrays or plain values."""

import numpy as np
import torch

from theanompi_tpu_torch import bridge
from theanompi_tpu_torch.tree import tree_leaves


def _mlp(batch, lr=None):
    from theanompi_tpu_torch.models.mlp import MLP

    recipe = MLP.default_recipe().replace(batch_size=batch)
    if lr is not None:
        recipe = recipe.replace(sched_kwargs={"lr": lr})
    return MLP(recipe)


def _np_tree(tree, layouts=None):
    return bridge.tree_to_jax(tree, layouts)


def _set_worker(state, model, params_np, vel_np):
    """``state.worker`` with the reference's params and velocities."""
    layouts = model.param_layouts(state.worker.params)
    worker = state.worker._replace(
        params=bridge.params_from_jax(params_np, layouts=layouts),
        opt_state=bridge.tree_from_jax(vel_np, layouts={"vel": layouts}))
    return state._replace(worker=worker), layouts


def easgd_rank(rank, n, device, params_np, vel_np, batches, avg_freq, codec):
    """EASGD on the MLP from the reference's initial weights: this rank's
    worker batch of each global batch, the exchange after every
    ``avg_freq``-th step -> losses, the worker's params and velocities,
    the center and the residual (reference layouts)."""
    from theanompi_tpu_torch.parallel.easgd import EASGDEngine
    from theanompi_tpu_torch.parallel.mesh import host_local_batch_slice

    torch.set_num_threads(1)
    model = _mlp(len(batches[0][0]) // n)
    engine = EASGDEngine(model, n, device, avg_freq=avg_freq, wire_codec=codec)
    state = engine.init_state(torch.Generator().manual_seed(0))
    state, layouts = _set_worker(state, model, params_np, vel_np)
    state = state._replace(center_params=bridge.params_from_jax(params_np, layouts=layouts))
    rows = host_local_batch_slice(len(batches[0][0]), rank, n)
    losses = []
    for i, (x, y) in enumerate(batches, 1):
        state, m = engine.train_step(state, torch.from_numpy(x[rows]), torch.from_numpy(y[rows]),
                                     None)
        losses.append(float(m["loss"]))
        if i % avg_freq == 0:
            state = engine.exchange(state)
    return {"losses": losses, "params": _np_tree(state.worker.params, layouts),
            "vel": _np_tree(state.worker.opt_state, {"vel": layouts}),
            "center": _np_tree(state.center_params, layouts),
            "ef": _np_tree(state.ef, layouts) if tree_leaves(state.ef) else None,
            "exchanges": engine.comm_rounds, "step": int(state.worker.step)}


def easgd_exchange_rank(rank, n, device, rows_np, center_np, ef_rows_np, codec, alpha):
    """One exchange from given worker rows (this rank's), center and
    residual rows -> the worker's params, the center and the residual
    (reference layouts)."""
    from theanompi_tpu_torch.parallel.easgd import EASGDEngine

    torch.set_num_threads(1)
    model = _mlp(8)
    engine = EASGDEngine(model, n, device, avg_freq=1, alpha=alpha, wire_codec=codec)
    state = engine.init_state(torch.Generator().manual_seed(0))
    layouts = model.param_layouts(state.worker.params)
    worker = state.worker._replace(params=bridge.params_from_jax(rows_np[rank], layouts=layouts))
    ef = state.ef
    if ef_rows_np is not None:
        ef = bridge.tree_from_jax(ef_rows_np[rank], layouts=layouts)
    state = state._replace(worker=worker, center_params=bridge.params_from_jax(center_np,
                                                                              layouts=layouts),
                           ef=ef)
    state = engine.exchange(state)
    return {"params": _np_tree(state.worker.params, layouts),
            "center": _np_tree(state.center_params, layouts),
            "ef": _np_tree(state.ef, layouts) if tree_leaves(state.ef) else None}


class ScriptedDraws:
    """Gossip draws given round by round: ``rounds[i] = (shift, pushes)``,
    ``pushes`` one bool a worker (the reference's draws, recovered)."""

    def __init__(self, rounds):
        self.rounds, self.i = list(rounds), 0

    def draw(self, worker):
        shift, pushes = self.rounds[self.i]
        self.i += 1
        return int(shift), bool(pushes[worker])

    def get_state(self, worker):
        return np.array([self.i], dtype=np.uint8)

    def set_state(self, row, worker):
        self.i = int(row[0])


def gosgd_round_rank(rank, n, device, rows_np, alphas, codec, rounds, batch):
    """GoSGD rounds from given worker rows and shares with scripted draws
    and lr 0 (the local step leaves the params as they are) -> the merged
    params (reference layout), the share and the residual after each
    round, and the rounds run."""
    from theanompi_tpu_torch.parallel.gosgd import GOSGDEngine

    torch.set_num_threads(1)
    model = _mlp(len(batch[0]) // n, lr=0.0)
    engine = GOSGDEngine(model, n, device, p_push=0.9, wire_codec=codec,
                         draws=ScriptedDraws(rounds))
    state = engine.init_state(torch.Generator().manual_seed(0))
    layouts = model.param_layouts(state.worker.params)
    state = state._replace(
        worker=state.worker._replace(params=bridge.params_from_jax(rows_np[rank],
                                                                   layouts=layouts)),
        alpha=torch.tensor(np.float32(alphas[rank])))
    per = len(batch[0]) // n
    x, y = (torch.from_numpy(a[rank * per:(rank + 1) * per]) for a in batch)
    out = []
    for _ in rounds:
        state, _ = engine.train_step(state, x, y, None)
        out.append({"params": _np_tree(state.worker.params, layouts),
                    "alpha": float(state.alpha),
                    "ef": state.ef.numpy().copy() if engine.use_ef else None})
    return {"rounds": out, "comm_rounds": engine.comm_rounds}


def gosgd_cadence_rank(rank, n, device, batches, cases):
    """GoSGD with the default draws on the MLP for each case
    (``{"p_push", "gossip_every", "lr"}``) -> the shares after each step,
    the rounds run and the worker's first param leaf at the end."""
    from theanompi_tpu_torch.parallel.gosgd import GOSGDEngine

    torch.set_num_threads(1)
    out = []
    for case in cases:
        model = _mlp(len(batches[0][0]) // n, lr=case.get("lr"))
        engine = GOSGDEngine(model, n, device, p_push=case["p_push"],
                             gossip_every=case.get("gossip_every", 1), seed=3)
        state = engine.init_state(torch.Generator().manual_seed(0))
        per = len(batches[0][0]) // n
        alphas = []
        for x, y in batches:
            state, _ = engine.train_step(state, torch.from_numpy(x[rank * per:(rank + 1) * per]),
                                         torch.from_numpy(y[rank * per:(rank + 1) * per]), None)
            alphas.append(float(state.alpha))
        out.append({"alphas": alphas, "comm_rounds": engine.comm_rounds,
                    "w0": tree_leaves(state.worker.params)[0].detach().numpy().copy()})
    return out


def training_rank(rank, n, device, runs):
    """``run_training`` of each ``(label, modelfile, modelclass, kwargs)``
    on this rank -> rank 0's summaries (``{label: summary}``); a run whose
    kwargs hold ``"expect_error"`` must raise ValueError, whose message
    is returned."""
    from theanompi_tpu_torch.launch.session import resolve_model
    from theanompi_tpu_torch.launch.worker import run_training

    torch.set_num_threads(1)
    out = {}
    for label, modelfile, modelclass, kw in runs:
        kw = dict(kw)
        rule = kw.pop("rule")
        if kw.pop("expect_error", False):
            try:
                run_training(rule, resolve_model(modelfile, modelclass), n, device=device, **kw)
                out[label] = None
            except ValueError as e:
                out[label] = str(e)
            continue
        out[label] = run_training(rule, resolve_model(modelfile, modelclass), n, device=device,
                                  **kw)
    return out if rank == 0 else None


def restore_rank(rank, n, device, rule, path, kw):
    """The rule engine's ``restore`` of the checkpoint at ``path`` on this
    rank (the MLP) -> its worker, center or share and residual in
    reference layouts."""
    from theanompi_tpu_torch.launch.session import resolve_model
    from theanompi_tpu_torch.parallel.easgd import EASGDEngine
    from theanompi_tpu_torch.parallel.gosgd import GOSGDEngine
    from theanompi_tpu_torch.utils.checkpoint import load_checkpoint

    torch.set_num_threads(1)
    model = resolve_model("theanompi_tpu_torch.models.mlp", "MLP")()
    engine = (EASGDEngine if rule == "easgd" else GOSGDEngine)(model, n, device, **kw)
    state = engine.init_state(torch.Generator().manual_seed(1))
    layouts = model.param_layouts(state.worker.params)
    state = engine.restore(load_checkpoint(path), state, layouts)
    out = {"params": _np_tree(state.worker.params, layouts),
           "vel": _np_tree(state.worker.opt_state, {"vel": layouts}),
           "step": int(state.worker.step)}
    if rule == "easgd":
        out["center"] = _np_tree(state.center_params, layouts)
        out["ef"] = _np_tree(state.ef, layouts) if tree_leaves(state.ef) else None
    else:
        out["alpha"] = float(state.alpha)
        out["ef"] = state.ef.numpy().copy() if engine.use_ef else None
    return out


def hop_rank(rank, n, device, shift, group_size):
    """``strategies._hop`` with ``shift`` over this rank's worker axis
    (the ranks at its position in every group of ``group_size``) and over
    its group's data axis -> what arrived, and the axes' members."""
    import torch.distributed as dist

    from theanompi_tpu_torch.parallel.mesh import bind_axes
    from theanompi_tpu_torch.parallel.strategies import _hop, mean_across_ranks

    axes = bind_axes(n, None, group_size)
    # one rank a group: the worker axis is the 1-D mesh's "data", the world
    wgroup, wn = axes["worker" if group_size > 1 else "data"]
    dgroup, dn = axes["data"]
    send = torch.full((3,), float(rank))
    return {"worker": _hop(send, wn, shift, wgroup).numpy(),
            "data": _hop(send + 100, dn, 1, dgroup).numpy(),
            "world": _hop(send, n, shift).numpy(),
            "worker_members": dist.get_process_group_ranks(wgroup),
            "data_members": dist.get_process_group_ranks(dgroup),
            "worker_mean": mean_across_ranks([send], wn, wgroup)[0].numpy(),
            "data_mean": mean_across_ranks([send], dn, dgroup)[0].numpy()}


def wrn_rule_rank(rank, n, device, rule, group_size, init, batches, val, recipe_kw, kw,
                  rounds=None):
    """``rule`` on WRN-16-4 (BatchNorm, no dropout) in workers of
    ``group_size`` ranks, BN over the group's ``"data"`` axis when that
    is more than one, from the reference's worker ``init`` (params, BN
    statistics, velocities; the center a copy): this rank's rows of each
    global batch, EASGD's exchange after every ``avg_freq``-th step,
    GoSGD's rounds drawn from ``rounds`` -> the losses, the worker's
    params, velocities and BN statistics, EASGD's center and its BN
    statistics, GoSGD's share, and the validation metrics of the global
    batch ``val`` (reference layouts)."""
    from theanompi_tpu_torch.models.model_zoo.wrn import WRN_16_4
    from theanompi_tpu_torch.parallel.easgd import EASGDEngine
    from theanompi_tpu_torch.parallel.gosgd import GOSGDEngine
    from theanompi_tpu_torch.parallel.mesh import host_local_batch_slice

    torch.set_num_threads(1)
    params_np, stats_np, vel_np = init
    recipe = WRN_16_4.default_recipe().replace(
        **recipe_kw, bn_axis_name="data" if group_size > 1 else None)
    model = WRN_16_4(recipe)
    if rule == "easgd":
        engine = EASGDEngine(model, n, device, group_size=group_size, **kw)
    else:
        engine = GOSGDEngine(model, n, device, group_size=group_size,
                             draws=ScriptedDraws(rounds), **kw)
    state = engine.init_state(torch.Generator().manual_seed(0))
    state, layouts = _set_worker(state, model, params_np, vel_np)
    state = state._replace(worker=state.worker._replace(
        model_state=bridge.tree_from_jax(stats_np)))
    if rule == "easgd":
        state = state._replace(center_params=bridge.params_from_jax(params_np, layouts=layouts),
                               center_model_state=bridge.tree_from_jax(stats_np))
    rows = host_local_batch_slice(len(batches[0][0]), rank, n)
    losses = []
    for i, (x, y) in enumerate(batches, 1):
        state, m = engine.train_step(state, torch.from_numpy(x[rows]), torch.from_numpy(y[rows]),
                                     None)
        losses.append(float(m["loss"]))
        if engine.exchange_every and i % engine.exchange_every == 0:
            state = engine.exchange(state)
    vrows = host_local_batch_slice(len(val[0]), rank, n)
    ev = engine.eval_step(state, torch.from_numpy(val[0][vrows]),
                          torch.from_numpy(val[1][vrows]))
    out = {"losses": losses, "params": _np_tree(state.worker.params, layouts),
           "vel": _np_tree(state.worker.opt_state, {"vel": layouts}),
           "stats": _np_tree(state.worker.model_state),
           "val": {k: float(v) for k, v in ev.items()}, "comm_rounds": engine.comm_rounds}
    if rule == "easgd":
        out["center"] = _np_tree(state.center_params, layouts)
        out["center_stats"] = _np_tree(state.center_model_state)
    else:
        out["alpha"] = float(state.alpha)
    return out
