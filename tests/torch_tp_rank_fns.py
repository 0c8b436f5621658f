"""Rank functions of the tensor-parallel port tests
(``tests/test_torch_tp.py``, ``tests/test_torch_tp_loop.py``), handed to
``theanompi_tpu_torch.launch.session.spawn_ranks``. Each runs in a fresh
process as one rank of a gloo process group on the CPU, so this module
imports the port only (no JAX) and returns numpy arrays, never tensors.
Each takes the whole global inputs, of which a rank uses its own shard."""

import numpy as np
import torch

from theanompi_tpu_torch import bridge


def vocab_nll_rank(rank, n, device, cases):
    """Each case ``(label, tp, logits [B, T, V], targets [B, T], w [B,
    T])`` on the ``(n / tp, tp)`` mesh: this rank's vocabulary columns
    through ``_vocab_sharded_nll`` over ``"model"`` -> ``{label: (nll,
    d sum(nll·w) / d local logits, tp index)}``."""
    from theanompi_tpu_torch.models.transformer import _vocab_sharded_nll
    from theanompi_tpu_torch.parallel.mesh import axis_index, bind_axes

    torch.set_num_threads(1)
    out = {}
    for label, tp, logits, targets, w in cases:
        bind_axes(n, tp=tp)
        t = axis_index("model")
        v = logits.shape[-1] // tp
        local = torch.from_numpy(logits[..., t * v:(t + 1) * v].copy()).requires_grad_(True)
        nll = _vocab_sharded_nll(local, torch.from_numpy(targets), "model")
        (nll * torch.from_numpy(w)).sum().backward()
        out[label] = (nll.detach().numpy(), local.grad.numpy(), t)
    return out


def state_from_reference(eng, params, opt_state):
    """The engine's state (this rank's shards, zero residuals) from the
    reference's global params and optimizer state (numpy trees), through
    the engine's checkpoint restore: the global entries cut to this rank's
    pieces."""
    from theanompi_tpu_torch.parallel.nd import NDTrainState

    init = eng.init_state(torch.Generator().manual_seed(0))
    layouts = eng.model.param_layouts(init.params)
    whole = NDTrainState(bridge.params_from_jax(params), bridge.opt_state_from_jax(opt_state),
                         init.step, ())
    flat = bridge.state_to_flat(whole, eng.model.param_layouts(whole.params))
    for k, (shape, dtype) in bridge.entry_shapes(eng.checkpoint_parts(init, layouts)).items():
        if k.startswith(".ef/"):
            flat[k] = np.zeros(shape, dtype)
    return eng.restore(flat, init, layouts)


def nd_train_rank(rank, n, device, runs):
    """Each run ``(label, tp, sp, recipe overrides, params, opt_state,
    batches, codec)``: ``NDEngine`` over the ``(n / (tp·sp), tp, sp)``
    mesh from those params and Adam state (the reference's global trees),
    one step a global batch, this rank reading its data index's rows ->
    ``{label: {"losses", "digest", "replicated_digest", "tp_index",
    "entries"}}``, ``entries`` the final state's global checkpoint entries
    on rank 0 (None elsewhere)."""
    from theanompi_tpu_torch.models.lm import TransformerLMModel
    from theanompi_tpu_torch.parallel.mesh import host_local_batch_slice
    from theanompi_tpu_torch.parallel.nd import NDEngine
    from theanompi_tpu_torch.utils.checkpoint import to_numpy

    torch.set_num_threads(1)
    out = {}
    for label, tp, sp, overrides, params, opt_state, batches, codec in runs:
        model = TransformerLMModel(TransformerLMModel.default_recipe().replace(**overrides))
        eng = NDEngine(model, n, "cpu", tp=tp, sp=sp, wire_codec=codec)
        state = state_from_reference(eng, params, opt_state)
        rows = host_local_batch_slice(batches[0].shape[0], eng.dp_index, eng.dp)
        losses = []
        for tokens in batches:
            x = torch.from_numpy(tokens[rows])
            state, m = eng.train_step(state, x, x, None)
            losses.append(float(m["loss"]))
        entries = eng.state_entries(state, model.param_layouts(state.params))
        summary = eng.rank_summary(state)
        out[label] = {"losses": losses, "digest": summary["replica_digest"],
                      "replicated_digest": summary["replicated_digest"],
                      "tp_index": summary["tp_index"],
                      "entries": ({k: to_numpy(v) for k, v in entries.items()}
                                  if entries is not None else None)}
    return out


def reshard_rank(rank, n, device, cases):
    """Each case ``(label, path, tp, sp, recipe overrides, codec)``: the
    checkpoint at ``path`` restored onto the ``(n / (tp·sp), tp, sp)``
    mesh through ``load_resharded`` and the engine's restore, then
    gathered back -> ``{label: (global entries on rank 0 or None, reshard
    info)}``."""
    from theanompi_tpu_torch.models.lm import TransformerLMModel
    from theanompi_tpu_torch.parallel.nd import NDEngine
    from theanompi_tpu_torch.utils.checkpoint import load_resharded, to_numpy

    torch.set_num_threads(1)
    out = {}
    for label, path, tp, sp, overrides, codec in cases:
        model = TransformerLMModel(TransformerLMModel.default_recipe().replace(**overrides))
        eng = NDEngine(model, n, "cpu", tp=tp, sp=sp, wire_codec=codec)
        init = eng.init_state(torch.Generator().manual_seed(0))
        layouts = model.param_layouts(init.params)
        target = bridge.entry_shapes(eng.checkpoint_parts(init, layouts))
        flat, info = load_resharded(path, target, eng.mesh_topology())
        state = eng.restore(flat, init, layouts)
        entries = eng.state_entries(state, layouts)
        out[label] = ({k: to_numpy(v) for k, v in entries.items()} if entries is not None
                      else None, info)
    return out


def parity_rank(rank, n, device, runs, nll_cases):
    """``nd_train_rank``'s runs and ``vocab_nll_rank``'s cases in one
    spawn."""
    out = nd_train_rank(rank, n, device, runs)
    out.update(vocab_nll_rank(rank, n, device, nll_cases))
    return out
