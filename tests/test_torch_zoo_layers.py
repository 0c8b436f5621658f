"""Every layer of the port's zoo models against the JAX package's, fed the
reference's own input of that layer (``tests/test_torch_zoo.py``'s
models, weights, batches and limits): its output, the BN statistics it
writes, and the gradients of <output, cotangent> for its params and its
input. Fed the same input, no layer sees the ReLU flips or the rounding
amplification of the layers before it, so every gradient holds
elementwise at the fp32 limits here, where the whole network's holds
only in relative norm.
"""

import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from theanompi_tpu_torch import bridge
from theanompi_tpu_torch.tree import tree_leaves, tree_map

from test_torch_zoo import CASES, _batches, _excess, _models, _rel_norm, _weights


def _layer_io(name, dtype="float32"):
    """Each top-level layer of the reference's network and the input it
    gets in one training forward (one jit of the whole forward) ->
    [(key, the reference's layer, the port's layer, input)]."""
    jm, tm = _models(name, dtype)
    jparams, _, jstate = _weights(name)
    x, _ = _batches(name)[0]

    def inputs(p, s, h):
        out = []
        for key, jl in zip(tm.net._keys, jm.net.layers):
            out.append(h)
            h, _ = jl.apply(p.get(key, {}), s.get(key, {}), h, train=True)
        return out

    hs = jax.jit(inputs)(jparams, jstate, jnp.asarray(x).astype(getattr(jnp, dtype)))
    return [(key, jl, tl, np.asarray(h.astype(jnp.float32)))
            for key, jl, tl, h in zip(tm.net._keys, jm.net.layers, tm.net.layers, hs)]


def _layer_vjp(name, dtype="float32", keys=None, op_by_op=None):
    """Per layer (``keys``: those only), fed the reference's input and a
    seeded cotangent: the output, the BN state written, and the
    gradients of <output, cotangent> for the layer's params and its
    input, in both packages -> [(key, reference's, port's)], each a list
    of numpy arrays: output, stats, param grads, input grad. ``op_by_op``:
    run the reference's layers op by op (default: as ``CASES`` says)."""
    op_by_op = CASES[name][4] if op_by_op is None else op_by_op
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jparams, layouts, jstate = _weights(name)
    r = np.random.RandomState(11)
    res = []
    for key, jl, tl, xin in _layer_io(name, dtype):
        if keys is not None and key not in keys:
            continue
        jp, js = jparams.get(key, {}), jstate.get(key, {})
        lay = layouts.get(key, {})

        def fwd_vjp(p, xx, ct, jl=jl, js=js):
            y, pull, ns = jax.vjp(lambda p_, x_: jl.apply(p_, js, x_, train=True), p, xx,
                                  has_aux=True)
            return y, ns, pull(ct.astype(y.dtype))

        xj = jnp.asarray(xin).astype(jdt)
        shape = jax.eval_shape(lambda p, xx: jl.apply(p, js, xx, train=True)[0], jp, xj).shape
        cot = r.randn(*shape).astype(np.float32)
        with jax.disable_jit() if op_by_op else contextlib.nullcontext():
            fn = fwd_vjp if op_by_op else jax.jit(fwd_vjp)
            jy, jns, (gp, gx) = fn(jp, xj, jnp.asarray(cot))
        ref = ([np.asarray(jy, np.float32)] + [np.asarray(s) for s in jax.tree_util.tree_leaves(jns)]
               + [np.asarray(g, np.float32) for g in jax.tree_util.tree_leaves(gp)]
               + [np.asarray(gx, np.float32)])
        tp = bridge.params_from_jax(jp, layouts=lay) if jp else {}
        ts = bridge.tree_from_jax(js) if js else {}
        tx = torch.from_numpy(xin).to(tdt).requires_grad_(True)
        ty, tns = tl.apply(tp, ts, tx, train=True)
        leaves = tree_leaves(tp)
        grads = torch.autograd.grad(ty, leaves + [tx], torch.from_numpy(cot).to(ty.dtype))
        it = iter(grads[:len(leaves)])
        tgp = bridge.tree_to_jax(tree_map(lambda _: next(it), tp), lay) if jp else {}
        port = ([ty.detach().float().numpy()]
                + [s.detach().numpy() for s in tree_leaves(tns if js else {})]
                + [np.asarray(g, np.float32) for g in jax.tree_util.tree_leaves(tgp)]
                + [grads[-1].float().numpy()])
        res.append((key, ref, port))
    return res


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_layer_and_its_gradients_match_the_reference(name):
    """Every top-level layer (a block of WRN and ResNet-50 as a whole),
    fed the reference's own input of that layer and a seeded cotangent:
    its output, the BN statistics it writes, the gradient of <output,
    cotangent> for each of its param leaves (all of the model's leaves
    over the layers) and for its input, each ``|a - b| <= 1e-4 |b| +
    1e-5 max|b|``. Fed the same input, no layer sees a ReLU flip or the
    amplification of the layers before it. Read: worst excess 0.37
    (ResNet-50), 0.11 (WRN-16-4), 0.06 or less elsewhere."""
    worst = 0.0
    n_params = 0
    for key, ref, port in _layer_vjp(name):
        assert len(ref) == len(port), key
        worst = max(worst, _excess(port, ref))
        n_params += len(ref) - 2
    _, tm = _models(name)
    print(f"[{name}] per-layer worst excess {worst:.3g}")
    params, state = tm.init_tree(torch.Generator().manual_seed(0))
    assert n_params == len(tree_leaves(params)) + len(tree_leaves(state))
    assert worst <= 1.0


def test_bf16_resnet50_batchnorm_layers_match_the_reference():
    """ResNet-50 at its recipe's bf16 compute (BN's bf16 branch: the
    statistics in fp32, the normalize sweep in bf16), layer by layer as in
    ``test_each_layer_and_its_gradients_match_the_reference``, at the
    stem's BN, the first block and the first block of the last stage:
    each output and each fp32 BN statistic within 2^-5 of its largest
    value (GoogLeNet's bf16 logits limit; read: 1.45e-2 at worst). As in
    GoogLeNet's bf16 test, gradients are not held in bf16: each package
    forms them from bf16 cotangents rounded at its own points (XLA's
    fusions among them), and they read 0.10 per leaf in relative norm
    here (6.4e-2 with the reference op by op); the fp32 tests hold every
    gradient. The whole bf16 network is not compared: its fp32 forward
    already moves 1.7e-4 of its largest logit under a one-ulp input change
    (``test_training_forward_matches_the_reference``), and bf16's ulp is
    2^16 times fp32's."""
    worst_out = worst_grad = 0.0
    layers = _layer_vjp("resnet50", "bfloat16", keys=("01_stem_bn", "04_res2a", "17_res5a"),
                        op_by_op=False)
    assert [k for k, _, _ in layers] == ["01_stem_bn", "04_res2a", "17_res5a"]
    _, tm = _models("resnet50")
    _, state = tm.init_tree(torch.Generator().manual_seed(0))
    for key, ref, port in layers:
        n_stats = len(tree_leaves(state[key]))
        head = 1 + n_stats  # the output and the stats
        for a, b in zip(port[:head], ref[:head]):
            worst_out = max(worst_out, float(np.abs(a - b).max() / np.abs(b).max()))
        worst_grad = max(worst_grad, _rel_norm(port[head:], ref[head:]))
    print(f"[resnet50 bf16] outputs and stats {worst_out:.3g} of max, grads {worst_grad:.3g}")
    assert worst_out <= 2.0 ** -5
