"""GoogLeNet (Inception v1).

Port of ``theanompi_tpu/models/googlenet.py`` module for module: the
stem (7x7/2 conv, 3x3/2 max pool, LRN, 1x1 and 3x3 convs, LRN, 3x3/2 max
pool), nine inception modules with the paper's channel table, two
auxiliary classifiers during training (weighted 0.3), and global average
pool + dropout 0.4 + linear. Recipe: batch 1024 (the reference's
32-worker global batch), momentum 0.9, weight decay 1e-4, poly LR decay,
224x224x3, 1000 classes, bf16 compute, fp32 params, He-normal conv
inits. The param tree is the reference's: 128 leaves (stem 6, 9
inceptions x 12, head 2, aux 2 x 6).

``GoogLeNet(recipe, pool_kernel=True)`` routes the nine inception pool
branches (3x3, stride 1, padding 1) to the pool kernels
(``ops/pool.py``, Theano's all-maxima backward) — the reference's
``TMPI_PALLAS_POOL=1``. The stem's and ``pool3``/``pool4``'s 3x3/s2
pools stay on ``F.max_pool2d`` either way, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from theanompi_tpu_torch import nn
from theanompi_tpu_torch.models.contract import (
    Model,
    Recipe,
    as_dtype,
    classification_metrics,
    softmax_cross_entropy,
)
from theanompi_tpu_torch.nn import init as initializers
from theanompi_tpu_torch.nn.layers import Layer, _nchw, _nhwc

_he = initializers.he_normal()


def _conv_relu(out_c, kernel, stride=1, padding="SAME", name="conv"):
    return [
        nn.Conv(out_c, kernel, stride=stride, padding=padding, w_init=_he, name=name),
        nn.Activation("relu"),
    ]


class _ConcatO(torch.autograd.Function):
    """``torch.cat`` of conv kernels along O (OIHW dim 0) whose backward
    hands each kernel its gradient slice in that kernel's own strides.
    A slice of the concatenated gradient keeps the strides the conv's
    backward chose for the whole, and a 1x1 kernel's size-1 dims leave
    those free; the fused optimizer kernel takes a gradient only with its
    parameter's strides (``ops/fused_update.py``)."""

    @staticmethod
    def forward(ctx, *ws):
        ctx.layouts = [(w.shape, w.stride()) for w in ws]
        return torch.cat(ws, dim=0)

    @staticmethod
    def backward(ctx, g):
        out, o = [], 0
        for shape, stride in ctx.layouts:
            dw = torch.empty_strided(shape, stride, dtype=g.dtype, device=g.device)
            out.append(dw.copy_(g[o:o + shape[0]]))
            o += shape[0]
        return tuple(out)


class Inception(Layer):
    """One inception module: 1x1 / 1x1-3x3 / 1x1-5x5 / pool-1x1 branches,
    channel-concatenated. ``pool_kernel``: the pool branch's 3x3/s1 max
    pool runs the pool kernel (``nn.Pool(kernel=True)``)."""

    def __init__(self, c1, c3r, c3, c5r, c5, cp, name="incept", pool_kernel=False):
        self.name = name
        self.c1, self.c3r, self.c5r = c1, c3r, c5r
        self.b1 = nn.Sequential(_conv_relu(c1, 1, name="b1"), name="b1")
        self.b3 = nn.Sequential(
            _conv_relu(c3r, 1, name="b3r") + _conv_relu(c3, 3, name="b3"), name="b3"
        )
        self.b5 = nn.Sequential(
            _conv_relu(c5r, 1, name="b5r") + _conv_relu(c5, 5, name="b5"), name="b5"
        )
        self.pool = nn.Pool(3, stride=1, padding=1, mode="max", kernel=pool_kernel)
        self.bp = nn.Sequential([self.pool] + _conv_relu(cp, 1, name="bp"), name="bp")
        self.branches = {"b1": self.b1, "b3": self.b3, "b5": self.b5, "bp": self.bp}
        # the fused front slices each branch at the end of its leading
        # conv+relu pair: pin that structure here, at build time
        self._front_len = len(_conv_relu(1, 1))
        for bname in ("b1", "b3", "b5"):
            branch = self.branches[bname]
            if not isinstance(branch.layers[0], nn.Conv):
                raise AssertionError(
                    f"Inception fused front expects branch {bname!r} to "
                    f"start with a Conv; got {type(branch.layers[0]).__name__}"
                )

    def init(self, gen, in_shape):
        params, state = {}, {}
        for bname, branch in self.branches.items():
            p, s = branch.init(gen, in_shape)
            params[bname] = p
            if bname != "bp" and not {"w", "b"} <= set(p[branch._keys[0]]):
                raise AssertionError(
                    f"Inception fused front expects branch {bname!r}'s "
                    f"leading conv params to carry 'w'/'b'; got "
                    f"{sorted(p[branch._keys[0]])}"
                )
            if s and bname != "bp":
                # the fused apply threads no state through the b1/b3/b5
                # tails: refuse a stateful layer (BatchNorm) there
                raise NotImplementedError(
                    f"Inception branch {bname!r} carries layer state "
                    f"({list(s)}); the fused-front apply only threads "
                    "state for the pool branch"
                )
            if s:
                state[bname] = s
        return params, state

    def apply(self, params, state, x, *, train=False, gen=None):
        # the b1 / b3-reduce / b5-reduce 1x1 convs read the same input:
        # ONE conv over their kernels concatenated along O (the reference's
        # concat along HWIO's last axis), then split; same param tree
        p1 = params["b1"][self.b1._keys[0]]
        p3r = params["b3"][self.b3._keys[0]]
        p5r = params["b5"][self.b5._keys[0]]
        w = _ConcatO.apply(p1["w"], p3r["w"], p5r["w"])
        b = torch.cat([p1["b"], p3r["b"], p5r["b"]])
        y = _nhwc(F.conv2d(_nchw(x), w.to(x.dtype)))
        y = F.relu(y + b.to(y.dtype))
        y1 = y[..., : self.c1]
        y3r = y[..., self.c1 : self.c1 + self.c3r]
        y5r = y[..., self.c1 + self.c3r :]

        def _tail(branch, bname, h):
            # the branch's layers after its leading conv + relu
            fl = self._front_len
            for lname, layer in zip(branch._keys[fl:], branch.layers[fl:]):
                h, _ = layer.apply(params[bname].get(lname, {}), {}, h, train=train, gen=gen)
            return h

        y3 = _tail(self.b3, "b3", y3r)
        y5 = _tail(self.b5, "b5", y5r)
        yp, _ = self.bp.apply(params["bp"], state.get("bp", {}), x, train=train, gen=gen)
        return torch.cat([y1, y3, y5, yp], dim=-1), state

    def out_shape(self, in_shape):
        n, h, w, _ = in_shape
        c = sum(b.out_shape(in_shape)[-1] for b in self.branches.values())
        return (n, h, w, c)

    def param_layouts(self, params) -> dict:
        return {bname: branch.param_layouts(params[bname])
                for bname, branch in self.branches.items() if bname in params}


class AuxHead(nn.Sequential):
    """Auxiliary classifier: 5x5/3 avg pool, 1x1 conv 128, FC 1024,
    dropout 0.7, linear (training-time only)."""

    def __init__(self, num_classes, name="aux"):
        super().__init__(
            [
                nn.Pool(5, stride=3, mode="avg"),
                *_conv_relu(128, 1, name="proj"),
                nn.Flatten(),
                nn.Dense(1024, w_init=_he, name="fc"),
                nn.Activation("relu"),
                nn.Dropout(0.7),
                nn.Dense(num_classes, name="out"),
            ],
            name=name,
        )


# (name, module config or pool marker); channel table per the paper
_INCEPTION_TABLE = [
    ("3a", (64, 96, 128, 16, 32, 32)),
    ("3b", (128, 128, 192, 32, 96, 64)),
    ("pool3", None),
    ("4a", (192, 96, 208, 16, 48, 64)),
    ("4b", (160, 112, 224, 24, 64, 64)),  # aux1 taps the output of 4a
    ("4c", (128, 128, 256, 24, 64, 64)),
    ("4d", (112, 144, 288, 32, 64, 64)),
    ("4e", (256, 160, 320, 32, 128, 128)),  # aux2 taps the output of 4d
    ("pool4", None),
    ("5a", (256, 160, 320, 32, 128, 128)),
    ("5b", (384, 192, 384, 48, 128, 128)),
]
_AUX_TAPS = {"4a": "aux1", "4d": "aux2"}


class GoogLeNet(Model):
    name = "googlenet"
    aux_weight = 0.3

    @classmethod
    def default_recipe(cls) -> Recipe:
        return Recipe(
            batch_size=1024,  # 32 workers x 32/worker, the reference's BSP config
            n_epochs=60,
            optimizer="momentum",
            opt_kwargs={"momentum": 0.9, "weight_decay": 1e-4},
            schedule="poly",
            sched_kwargs={"lr": 0.04, "total_steps": 60, "power": 0.5},
            lr_unit="epoch",
            input_shape=(224, 224, 3),
            num_classes=1000,
            compute_dtype=torch.bfloat16,
            dataset="imagenet",
        )

    def build(self):
        ncls = self.recipe.num_classes
        self.stem = nn.Sequential(
            [
                *_conv_relu(64, 7, stride=2, name="conv1"),
                nn.Pool(3, stride=2, mode="max", padding=1),
                nn.LRN(),
                *_conv_relu(64, 1, name="conv2r"),
                *_conv_relu(192, 3, name="conv2"),
                nn.LRN(),
                nn.Pool(3, stride=2, mode="max", padding=1),
            ],
            name="stem",
        )
        self.blocks: list[tuple[str, Layer]] = []
        for bname, cfg in _INCEPTION_TABLE:
            if cfg is None:
                self.blocks.append((bname, nn.Pool(3, stride=2, mode="max", padding=1)))
            else:
                self.blocks.append((bname, Inception(*cfg, name=bname,
                                                     pool_kernel=self.pool_kernel)))
        self.head = nn.Sequential(
            [nn.GlobalAvgPool(), nn.Dropout(0.4), nn.Dense(ncls, name="out")],
            name="head",
        )
        self.aux = {"aux1": AuxHead(ncls, name="aux1"), "aux2": AuxHead(ncls, name="aux2")}
        return None  # custom init / apply below

    def block_inputs(self):
        """``(name, block, input shape)`` along the trunk, and the shape
        the head sees."""
        shape = self.stem.out_shape(self.input_shape)
        out = []
        for bname, block in self.blocks:
            out.append((bname, block, shape))
            shape = block.out_shape(shape)
        return out, shape

    def kernel_pools(self) -> list:
        blocks, _ = self.block_inputs()
        return [f"{bname}.bp" for bname, block, shape in blocks
                if isinstance(block, Inception)
                and block.pool.routes_to_kernel(torch.empty(shape, device="meta"))]

    # -- custom init / apply (branching graph, aux heads) --------------------
    def init_tree(self, gen):
        params, state = {}, {}
        p, s = self.stem.init(gen, self.input_shape)
        params["stem"] = p
        if s:
            state["stem"] = s
        blocks, head_shape = self.block_inputs()
        aux_shapes = {}
        for bname, block, shape in blocks:
            p, s = block.init(gen, shape)
            if p:
                params[bname] = p
            if s:
                state[bname] = s
            if bname in _AUX_TAPS:
                aux_shapes[_AUX_TAPS[bname]] = block.out_shape(shape)
        p, s = self.head.init(gen, head_shape)
        params["head"] = p
        if s:
            state["head"] = s
        for aux_name, aux in self.aux.items():
            p, s = aux.init(gen, aux_shapes[aux_name])
            params[aux_name] = p
            if s:
                state[aux_name] = s
        return params, state

    def apply(self, params, state, images, *, train: bool = False, gen=None):
        x = images.to(as_dtype(self.recipe.compute_dtype))
        new_state = dict(state)
        x, s = self.stem.apply(params["stem"], state.get("stem", {}), x, train=train, gen=gen)
        if s:
            new_state["stem"] = s
        aux_in = {}
        for bname, block in self.blocks:
            x, s = block.apply(params.get(bname, {}), state.get(bname, {}), x, train=train,
                               gen=gen)
            if s:
                new_state[bname] = s
            if bname in _AUX_TAPS:
                aux_in[_AUX_TAPS[bname]] = x
        logits, s = self.head.apply(params["head"], state.get("head", {}), x, train=train,
                                    gen=gen)
        if s:
            new_state["head"] = s
        if not train:
            return logits, new_state
        aux_logits = [aux.apply(params[aux_name], state.get(aux_name, {}), aux_in[aux_name],
                                train=train, gen=gen)[0]
                      for aux_name, aux in self.aux.items()]
        return (logits, *aux_logits), new_state

    def param_layouts(self, params):
        layers = {"stem": self.stem, **dict(self.blocks), "head": self.head, **self.aux}
        return {k: layers[k].param_layouts(v) for k, v in params.items()}

    def loss(self, logits, labels):
        if isinstance(logits, tuple):
            main, *aux = logits
            loss = softmax_cross_entropy(main, labels)
            for a in aux:
                loss = loss + self.aux_weight * softmax_cross_entropy(a, labels)
            return loss
        return softmax_cross_entropy(logits, labels)

    def metrics(self, logits, labels):
        if isinstance(logits, tuple):
            logits = logits[0]
        return classification_metrics(logits, labels)
