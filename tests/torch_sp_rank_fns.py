"""Rank functions of the sequence-parallel port tests
(``tests/test_torch_ring_attention.py``, ``tests/test_torch_sp.py``),
handed to ``theanompi_tpu_torch.launch.session.spawn_ranks``. Each runs
in a fresh process as one rank of a gloo process group on the CPU, so
this module imports the port only (no JAX) and returns numpy arrays,
never tensors. Every function binds the ``(dp, sp)`` mesh first
(``parallel/mesh.py``) and takes the whole global inputs, of which it
uses its own shard."""

import torch

from theanompi_tpu_torch import bridge

SCHEMES = ("ring", "ring_flash", "ulysses", "ulysses_flash")


def _attention_fn(scheme):
    import functools

    from theanompi_tpu_torch.ops.flash_attention import flash_attention, ring_flash_attention
    from theanompi_tpu_torch.ops.ring_attention import ring_attention, ulysses_attention

    return {"ring": ring_attention,
            "ring_flash": functools.partial(ring_flash_attention, block_k=64),
            "ring_flash_serial": functools.partial(ring_flash_attention, block_k=64,
                                                   overlap=False),
            "ulysses": ulysses_attention,
            "ulysses_flash": functools.partial(ulysses_attention, local_fn=flash_attention)}[scheme]


def attention_rank(rank, n, device, cases):
    """Each case ``(label, scheme, causal, dtype, q, k, v, g)`` (global
    ``[B, T, H, D]`` float32 arrays, ``g`` the output's cotangent) on this
    rank's sequence shard -> ``{label: (o, dq, dk, dv)}`` of the shard, as
    float32 (``dtype``: the inputs cast first, ``"float32"`` or
    ``"bfloat16"``)."""
    from theanompi_tpu_torch.parallel.mesh import bind_axes

    torch.set_num_threads(1)
    bind_axes(n, sp=n)
    out = {}
    for label, scheme, causal, dtype, q, k, v, g in cases:
        t = q.shape[1] // n
        sl = slice(rank * t, (rank + 1) * t)
        dt = getattr(torch, dtype)
        qs, ks, vs = (torch.from_numpy(a[:, sl].copy()).to(dt).requires_grad_(True)
                      for a in (q, k, v))
        try:
            o = _attention_fn(scheme)(qs, ks, vs, "seq", causal=causal)
        except ValueError as e:
            out[label] = str(e)
            continue
        (o.float() * torch.from_numpy(g[:, sl].copy())).sum().backward()
        out[label] = tuple(x.detach().float().numpy() for x in (o, qs.grad, ks.grad, vs.grad))
    return out


def loss_rank(rank, n, device, params, cases):
    """Each case ``(label, arch kwargs, tokens [B, T])`` -> ``{label: loss
    of this rank}`` under the sequence axis of all ``n`` ranks (the
    message of a ``ValueError`` in its place)."""
    from theanompi_tpu_torch.models.transformer import TransformerLM
    from theanompi_tpu_torch.parallel.mesh import bind_axes

    torch.set_num_threads(1)
    bind_axes(n, sp=n)
    p = bridge.params_from_jax(params)
    out = {}
    for label, kw, tokens in cases:
        t = tokens.shape[1] // n
        arch = TransformerLM(**kw)
        try:
            with torch.no_grad():
                out[label] = float(arch.loss(
                    p, torch.from_numpy(tokens[:, rank * t:(rank + 1) * t]), "seq"))
        except ValueError as e:  # a refusal, by its message
            out[label] = str(e)
    return out


def nd_train_rank(rank, n, device, runs):
    """Each run ``(label, sp, recipe overrides, params, opt_state, batches,
    codec)``: ``NDEngine`` over the ``(n / sp, sp)`` mesh from those
    params and Adam state (the reference's trees), one step a global
    batch, this rank reading its data row's rows -> ``{label: {"losses",
    "params", "m", "v", "t", "ef", "digest"}}``."""
    from theanompi_tpu_torch.models.lm import TransformerLMModel
    from theanompi_tpu_torch.parallel.mesh import host_local_batch_slice
    from theanompi_tpu_torch.parallel.nd import NDEngine, NDTrainState
    from theanompi_tpu_torch.tree import digest, tree_leaves

    torch.set_num_threads(1)
    out = {}
    for label, sp, overrides, params, opt_state, batches, codec in runs:
        model = TransformerLMModel(TransformerLMModel.default_recipe().replace(**overrides))
        eng = NDEngine(model, n, "cpu", sp=sp, wire_codec=codec)
        init = eng.init_state(torch.Generator().manual_seed(0))
        state = NDTrainState(bridge.params_from_jax(params),
                             bridge.opt_state_from_jax(opt_state), init.step, init.ef)
        rows = host_local_batch_slice(batches[0].shape[0], eng.dp_index, eng.dp)
        losses = []
        for tokens in batches:
            x = torch.from_numpy(tokens[rows])
            state, m = eng.train_step(state, x, x, None)
            losses.append(float(m["loss"]))
        opt = bridge.opt_state_to_jax(state.opt_state)
        out[label] = {"losses": losses, "params": bridge.params_to_jax(state.params),
                      "m": opt["m"], "v": opt["v"], "t": int(opt["t"]),
                      "ef": bridge.tree_to_jax(state.ef) if tree_leaves(state.ef) else None,
                      "digest": digest(tree_leaves((state.params, state.opt_state)))}
    return out
