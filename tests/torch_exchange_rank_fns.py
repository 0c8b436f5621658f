"""Rank functions of ``tests/test_torch_cross_bn.py``,
``tests/test_torch_bucketed.py`` and ``tests/test_torch_hier.py`` for
``theanompi_tpu_torch.launch.session.spawn_ranks``: each runs in a fresh
process as one rank of a gloo process group, imports the port only (no
JAX) and returns numpy arrays or plain values."""

import torch

from theanompi_tpu_torch import bridge
from theanompi_tpu_torch.tree import tree_leaves, tree_map

from torch_rank_fns import AlexNetNoDropout


def _np(t):
    return t.detach().float().numpy()


def bn_rank(rank, n, device, cases):
    """``BatchNorm(axis_name=case["axis"])`` in training on this rank's
    rows of each case (bound as ``case["slices"]`` slices) -> its output,
    new statistics and the gradients of ``sum(y * ct)`` with respect to
    x, scale and bias; and the message of an unknown axis name."""
    from theanompi_tpu_torch.nn.layers import BatchNorm
    from theanompi_tpu_torch.parallel.mesh import bind_axes

    torch.set_num_threads(1)
    out = []
    for case in cases:
        bind_axes(n, case["slices"])
        dtype = getattr(torch, case["dtype"])
        x = torch.from_numpy(case["x"][rank]).to(dtype).requires_grad_(True)
        ct = torch.from_numpy(case["ct"][rank])
        params = {k: torch.from_numpy(v.copy()).requires_grad_(True)
                  for k, v in case["params"].items()}
        state = {k: torch.from_numpy(v.copy()) for k, v in case["state"].items()}
        bn = BatchNorm(axis_name=case["axis"])
        y, new_state = bn.apply(params, state, x, train=True)
        gx, gs, gb = torch.autograd.grad((y.float() * ct).sum(),
                                         [x, params["scale"], params["bias"]])
        out.append({"y": _np(y), "mean": _np(new_state["mean"]), "var": _np(new_state["var"]),
                    "gx": _np(gx), "gscale": _np(gs), "gbias": _np(gb)})
    try:
        BatchNorm(axis_name="model").apply(params, state, x, train=True)
        unknown = None
    except NameError as e:
        unknown = str(e)
    return {"cases": out, "unknown": unknown}


def _alexnet(batch, compute=torch.float32):
    from theanompi_tpu_torch.models.alex_net import AlexNet

    return AlexNetNoDropout(AlexNet.default_recipe().replace(
        input_shape=(67, 67, 3), num_classes=10, batch_size=batch, compute_dtype=compute))


def _run(rank, n, device, params_np, vel_np, batches, group=0, **engine_kw):
    """BSP steps of the 67x67 no-dropout AlexNet from the given weights on
    this rank's shard of each global batch (``group > 1``: in fused
    groups of that many) -> losses, params, velocities and residuals."""
    from theanompi_tpu_torch.parallel.bsp import BSPEngine
    from theanompi_tpu_torch.parallel.mesh import host_local_batch_slice

    model = _alexnet(len(batches[0][0]))
    engine = BSPEngine(model, n, device, **engine_kw)
    state = engine.init_state(torch.Generator().manual_seed(0))
    layouts = model.param_layouts(state.params)
    if params_np is not None:
        state = state._replace(params=bridge.params_from_jax(params_np, layouts=layouts,
                                                             device=device),
                               opt_state=bridge.tree_from_jax(vel_np, device,
                                                              layouts={"vel": layouts}))
    rows = host_local_batch_slice(len(batches[0][0]), rank, n)
    xs = [torch.from_numpy(x[rows]) for x, _ in batches]
    ys = [torch.from_numpy(y[rows]) for _, y in batches]
    losses = []
    if group > 1:
        for i in range(0, len(xs), group):
            state, m = engine.fused_train_step(state, xs[i:i + group], ys[i:i + group], None)
            losses += [float(v) for v in m["loss"]]
    else:
        for x, y in zip(xs, ys):
            state, m = engine.train_step(state, x, y, None)
            losses.append(float(m["loss"]))
    ef = state.ef
    return {"losses": losses, "params": bridge.params_to_jax(state.params, layouts),
            "vel": bridge.tree_to_jax(state.opt_state, {"vel": layouts}),
            "ef": [_np(e) for e in tree_leaves(ef)], "step": int(state.step),
            "n_buckets": (len(engine.grad_sync.buckets_for(state.params))
                          if hasattr(engine.grad_sync, "buckets_for") else None)}


def exchange_rank(rank, n, device, params_np, vel_np, batches, runs):
    """Each ``runs[label]`` (``BSPEngine`` keyword arguments, ``group``)
    from the same weights -> ``{label: _run(...)}``."""
    torch.set_num_threads(1)
    return {label: _run(rank, n, device, params_np, vel_np, batches, **kw)
            for label, kw in runs.items()}


def hier_strategies_rank(rank, n, device, grads_np, ef_np, cases, slices, bucket_mb):
    """hier (and hier in buckets) exchanges of this rank's gradient tree
    over ``slices`` slices -> ``{case: (synced grads, ef' rows)}``."""
    from theanompi_tpu_torch.parallel.codec import get_codec
    from theanompi_tpu_torch.parallel.mesh import bind_axes, slice_topology
    from theanompi_tpu_torch.parallel.strategies import bucketed, get_strategy

    torch.set_num_threads(1)
    bind_axes(n, slices)
    sizes = slice_topology(n, slices)
    out = {}
    for case, (codec, buckets) in cases.items():
        grads = bridge.tree_from_jax(grads_np[rank])
        if buckets:
            sync = bucketed("hier", n, bucket_mb, codec, layouts=bridge.default_layouts,
                            axis_sizes=sizes)
        else:
            sync = get_strategy("hier", n, codec=codec, layouts=bridge.default_layouts,
                                axis_sizes=sizes)
        if get_codec(codec).error_feedback:
            rows = ef_np[case][rank]
            ef = (tuple(torch.from_numpy(r.copy()) for r in rows) if buckets
                  else torch.from_numpy(rows.copy()))
            synced, ef = sync(grads, ef)
            out[case] = (bridge.tree_to_jax(synced), [_np(e) for e in tree_leaves(ef)])
        elif buckets:
            # the in-backward round, fed the gradients as the backward would
            params = bridge.tree_from_jax(grads_np[rank], requires_grad=True)
            leaves = tree_leaves(params)
            loss = sum((p * g).sum() for p, g in zip(leaves, tree_leaves(grads)))
            round_ = sync.begin(params)
            local = torch.autograd.grad(loss, leaves)
            it = iter(local)
            synced = round_.finish(tree_map(lambda _: next(it), params))
            out[case] = (bridge.tree_to_jax(synced), [])
        else:
            out[case] = (bridge.tree_to_jax(sync(grads)), [])
    return out
