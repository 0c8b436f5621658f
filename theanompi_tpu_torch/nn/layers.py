"""Functional layers: Conv / Pool / LRN / Dense / Dropout / BatchNorm /
Activation / Flatten / GlobalAvgPool / Sequential.

Port of ``theanompi_tpu/nn/layers.py`` with the same contract:

    params, state = layer.init(gen, in_shape)     # in_shape includes batch
    y, new_state  = layer.apply(params, state, x, train=..., gen=...)
    out_shape     = layer.out_shape(in_shape)

``params``/``state`` are plain dicts of tensors under the reference's
names, so a whole model is one tree the bridge maps key for key.

Layouts. Every layer takes and returns NHWC tensors, as the reference
does. Inside, a conv or pool views its input as NCHW with
``permute(0, 3, 1, 2)``: the view of a contiguous NHWC tensor IS the
``channels_last`` memory format, so cuDNN runs in channels_last with no
copy, and the output permutes back to a contiguous NHWC view. Conv
weights are stored OIHW (PyTorch's layout) in channels_last memory
(``conv_weight_layout``); the Conv layer tags them ``CONV_KERNEL``
(``param_layouts``), and the bridge, the exchange and the codec map
tagged leaves to and from the reference's HWIO. Every other leaf, of
any rank, is ``PLAIN``: the reference's shape and strides. Dense
weights keep the reference's ``(in, out)`` layout, and ``Flatten``
flattens NHWC, so ``fc6``'s rows run in (h, w, c) order exactly as in
the reference.

Precision follows the reference: weights are cast to ``x.dtype`` where
they are used (their grads come back in the param dtype), the bias is
added in the output's dtype, and the LRN band sum comes out in x's
dtype.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F

from theanompi_tpu_torch.nn import init as initializers
from theanompi_tpu_torch.ops import pool as pool_ops

Shape = tuple  # includes leading batch dim


def _pair(v) -> tuple:
    return (v, v) if isinstance(v, int) else tuple(v)


def _spatial_out(h, w, kernel, stride, padding):
    """Output (h, w) for a windowed op with SAME/VALID/explicit padding."""
    kh, kw = kernel
    sh, sw = stride
    if padding == "SAME":
        return -(-h // sh), -(-w // sw)
    if padding == "VALID":
        return (h - kh) // sh + 1, (w - kw) // sw + 1
    ph, pw = _pair(padding)
    return (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1


def _same_pad(size: int, k: int, s: int) -> tuple:
    """XLA's SAME padding for one spatial dim: (low, high)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pads(padding, h, w, kernel, stride) -> tuple:
    """((top, bottom), (left, right)) for SAME/VALID/explicit padding."""
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding == "SAME":
        return _same_pad(h, kernel[0], stride[0]), _same_pad(w, kernel[1], stride[1])
    ph, pw = _pair(padding)
    return (ph, ph), (pw, pw)


def conv_weight_layout(w: torch.Tensor) -> torch.Tensor:
    """Conv kernels live OIHW in ``channels_last`` memory (physically
    OHWI): cuDNN then runs channels_last with no per-step weight copy, and
    the weight's gradient comes back in the same layout as the weight, so
    the fused optimizer kernel sees p, v and g with one set of strides."""
    return w.contiguous(memory_format=torch.channels_last)


# Leaf layouts: how a parameter-shaped leaf (a weight, or its gradient,
# velocity, moment or residual) is laid out here against the reference.
# A model declares one tag per leaf (``Model.param_layouts``).
PLAIN = "plain"  # the reference's shape, default contiguous strides
CONV_KERNEL = "conv"  # OIHW in channels_last memory here, HWIO there


def to_reference_layout(t: torch.Tensor, layout: str = PLAIN) -> torch.Tensor:
    """A leaf as the reference lays it out: a ``CONV_KERNEL`` leaf OIHW
    here and HWIO there; a ``PLAIN`` leaf, of any rank, the same in
    both. A view (no copy); ``.reshape(-1)`` of it is the reference's flat
    element order, which the gradient exchange and the int8 codec's
    128-element blocks follow (``parallel/strategies.py``,
    ``parallel/codec.py``)."""
    return t.permute(2, 3, 1, 0) if layout == CONV_KERNEL else t


def from_reference_layout(t: torch.Tensor, layout: str = PLAIN) -> torch.Tensor:
    """Inverse of :func:`to_reference_layout`: HWIO back to OIHW in the
    conv weights' own memory layout; other leaves made contiguous."""
    if layout == CONV_KERNEL:
        return conv_weight_layout(t.permute(3, 2, 0, 1))
    return t.contiguous()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Layer:
    """Base class: stateless identity. Subclasses override as needed."""

    name: str = "layer"

    def init(self, gen, in_shape: Shape):
        del gen, in_shape
        return {}, {}

    def apply(self, params, state, x, *, train: bool = False, gen=None):
        del params, train, gen
        return x, state

    def out_shape(self, in_shape: Shape) -> Shape:
        return in_shape

    def param_layouts(self, params) -> dict:
        """One layout tag per leaf of this layer's ``params``."""
        return {k: PLAIN for k in params}


class Conv(Layer):
    """2-D convolution with channel groups (AlexNet's two towers).

    ``padding``: int / (int, int) explicit symmetric pad, or 'SAME'
    (XLA's rule: total ``max((ceil(h/s)-1)*s + k - h, 0)``, low half
    ``total//2`` — asymmetric pads are applied with ``F.pad``) or 'VALID'.
    """

    def __init__(
        self,
        out_channels: int,
        kernel: Union[int, tuple],
        stride: Union[int, tuple] = 1,
        padding: Union[int, tuple, str] = "SAME",
        groups: int = 1,
        use_bias: bool = True,
        w_init=None,
        b_init=None,
        name: str = "conv",
    ):
        self.out_channels = out_channels
        self.kernel = _pair(kernel)
        self.stride = _pair(stride)
        self.padding = padding
        self.groups = groups
        self.use_bias = use_bias
        self.w_init = w_init or initializers.he_normal()
        self.b_init = b_init or initializers.zeros
        self.name = name

    def init(self, gen, in_shape: Shape):
        cin = in_shape[-1]
        if cin % self.groups or self.out_channels % self.groups:
            raise ValueError(
                f"{self.name}: channels {cin}->{self.out_channels} do not divide "
                f"into {self.groups} groups"
            )
        kh, kw = self.kernel
        # drawn in the reference's HWIO shape (same fans), stored OIHW
        w = self.w_init(gen, (kh, kw, cin // self.groups, self.out_channels))
        params = {"w": conv_weight_layout(w.permute(3, 2, 0, 1))}
        if self.use_bias:
            params["b"] = self.b_init(gen, (self.out_channels,))
        return params, {}

    def apply(self, params, state, x, *, train=False, gen=None):
        xc = _nchw(x)
        (pt, pb), (pl, pr) = _pads(self.padding, xc.shape[2], xc.shape[3],
                                   self.kernel, self.stride)
        if pt == pb and pl == pr:
            pad = (pt, pl)
        else:
            xc = F.pad(xc, (pl, pr, pt, pb))
            pad = (0, 0)
        y = F.conv2d(xc, params["w"].to(x.dtype), stride=self.stride,
                     padding=pad, groups=self.groups)
        y = _nhwc(y)
        if self.use_bias:
            y = y + params["b"].to(y.dtype)
        return y, state

    def out_shape(self, in_shape: Shape) -> Shape:
        n, h, w, _ = in_shape
        oh, ow = _spatial_out(h, w, self.kernel, self.stride, self.padding)
        return (n, oh, ow, self.out_channels)

    def param_layouts(self, params) -> dict:
        return {k: CONV_KERNEL if k == "w" else PLAIN for k in params}


class Pool(Layer):
    """Max / average pooling. AlexNet's overlapping pool = 3x3 stride 2
    VALID. Max pads with -inf; avg pads with zeros and divides by the
    full window (explicit pads) or by the window's real coverage (SAME),
    as the reference does.

    ``kernel=True`` (max only): where ``ops.pool.routable`` holds (3x3,
    stride 1, SAME-equivalent padding), the pool runs the hand-written
    kernels with Theano's all-maxima backward (``ops.pool.maxpool3x3_s1``)
    — the port's per-layer spelling of the reference's
    ``TMPI_PALLAS_POOL=1``. Otherwise a max pool's backward is
    ``F.max_pool2d``'s, which, like XLA's select-and-scatter, sends each
    window's gradient to its first maximum."""

    def __init__(
        self,
        window: Union[int, tuple] = 2,
        stride: Optional[Union[int, tuple]] = None,
        padding: Union[int, tuple, str] = "VALID",
        mode: str = "max",
        name: str = "pool",
        kernel: bool = False,
    ):
        self.window = _pair(window)
        self.stride = _pair(stride) if stride is not None else self.window
        self.padding = padding
        if mode not in ("max", "avg"):
            raise ValueError(f"pool mode must be 'max' or 'avg', got {mode!r}")
        if kernel and mode != "max":
            raise ValueError("the pool kernel is a max pool; kernel=True needs mode='max'")
        self.mode = mode
        self.name = name
        self.kernel = kernel

    def routes_to_kernel(self, x) -> bool:
        """Does ``apply`` on ``x`` (a tensor, or a meta tensor of its
        shape) run the pool kernel?"""
        return self.kernel and pool_ops.routable(self.window, self.stride, self.padding, x)

    def apply(self, params, state, x, *, train=False, gen=None):
        if self.routes_to_kernel(x):
            return pool_ops.maxpool3x3_s1(x), state
        xc = _nchw(x)
        (pt, pb), (pl, pr) = _pads(self.padding, xc.shape[2], xc.shape[3],
                                   self.window, self.stride)
        padded = any((pt, pb, pl, pr))
        if self.mode == "max":
            if padded:
                xc = F.pad(xc, (pl, pr, pt, pb), value=float("-inf"))
            y = F.max_pool2d(xc, self.window, self.stride)
        else:
            kh, kw = self.window
            xp = F.pad(xc, (pl, pr, pt, pb)) if padded else xc
            summed = F.avg_pool2d(xp, self.window, self.stride, divisor_override=1)
            if self.padding == "SAME":
                ones = torch.ones((1, 1, xc.shape[2], xc.shape[3]), dtype=x.dtype,
                                  device=x.device)
                ones = F.pad(ones, (pl, pr, pt, pb)) if padded else ones
                counts = F.avg_pool2d(ones, self.window, self.stride, divisor_override=1)
                y = summed / counts
            else:
                y = summed / (kh * kw)
        return _nhwc(y), state

    def out_shape(self, in_shape: Shape) -> Shape:
        n, h, w, c = in_shape
        oh, ow = _spatial_out(h, w, self.window, self.stride, self.padding)
        return (n, oh, ow, c)


class LRN(Layer):
    """Cross-channel local response normalization (pylearn2 convention):

    ``y = x / (k + (alpha/n) * sum_{|i-j| <= n//2} x_j^2)^beta``

    The window sum is a banded [C, C] matmul on the NHWC channel axis, as
    in the reference; for beta = 0.75, ``d^-beta = rsqrt(d)*rsqrt(sqrt(d))``.
    """

    def __init__(self, n: int = 5, alpha: float = 1e-4, beta: float = 0.75,
                 k: float = 2.0, name: str = "lrn"):
        if n % 2 != 1:
            raise ValueError(f"LRN window n must be odd, got {n}")
        self.n = n
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self.name = name
        self._bands: dict = {}

    def _band(self, c: int, dtype, device) -> torch.Tensor:
        key = (c, dtype, device)
        if key not in self._bands:
            i = torch.arange(c, device=device)
            self._bands[key] = ((i[:, None] - i[None, :]).abs() <= self.n // 2).to(dtype)
        return self._bands[key]

    def apply(self, params, state, x, *, train=False, gen=None):
        sq = torch.square(x)
        window_sum = sq @ self._band(x.shape[-1], x.dtype, x.device)
        d = self.k + (self.alpha / self.n) * window_sum
        if self.beta == 0.75:
            return (x * torch.rsqrt(d) * torch.rsqrt(torch.sqrt(d))).to(x.dtype), state
        return (x / torch.pow(d, self.beta)).to(x.dtype), state


class Dense(Layer):
    """Fully connected layer; weight in the reference's ``(in, out)`` layout."""

    def __init__(self, out_features: int, use_bias: bool = True, w_init=None,
                 b_init=None, name: str = "fc"):
        self.out_features = out_features
        self.use_bias = use_bias
        self.w_init = w_init or initializers.glorot_uniform()
        self.b_init = b_init or initializers.zeros
        self.name = name

    def init(self, gen, in_shape: Shape):
        params = {"w": self.w_init(gen, (in_shape[-1], self.out_features))}
        if self.use_bias:
            params["b"] = self.b_init(gen, (self.out_features,))
        return params, {}

    def apply(self, params, state, x, *, train=False, gen=None):
        y = x @ params["w"].to(x.dtype)
        if self.use_bias:
            y = y + params["b"].to(y.dtype)
        return y, state

    def out_shape(self, in_shape: Shape) -> Shape:
        return (*in_shape[:-1], self.out_features)


class Dropout(Layer):
    """Inverted dropout; the mask is drawn from the explicit generator
    ``gen`` (on x's device). Eval mode is the identity."""

    def __init__(self, rate: float = 0.5, name: str = "dropout"):
        self.rate = rate
        self.name = name

    def apply(self, params, state, x, *, train=False, gen=None):
        if not train or self.rate == 0.0:
            return x, state
        if gen is None:
            raise ValueError("Dropout.apply(train=True) needs a generator (gen=)")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        return torch.where(mask, x / keep, zero).to(x.dtype), state


class BatchNorm(Layer):
    """Batch normalization with running-stat state.

    ``axis_name``: ``None`` keeps per-replica statistics, which a BSP step
    averages across ranks after the step (``parallel/bsp.py``, as the
    reference's ``pmean``). A mesh axis name (``"data"``, and under
    ``--slices`` also ``"dcn"`` or ``("dcn", "data")``) is the
    reference's cross-replica BN: in training the batch mean and E[x²]
    are averaged over the ranks along that axis inside the step, in one
    ``all_reduce`` of the two concatenated, and the gradient flows back
    across the ranks (``parallel/mesh.py::pmean``). The name is looked
    up at the first training step: outside a BSP run of several ranks it
    is unbound and raises ``NameError`` (the reference's one-device step
    raises the same for its unbound ``pmean``), and so does a name the
    run's mesh does not have."""

    def __init__(self, momentum: float = 0.9, eps: float = 1e-5,
                 axis_name=None, name: str = "bn"):
        self.axis_name = axis_name
        self.momentum = momentum
        self.eps = eps
        self.name = name

    def init(self, gen, in_shape: Shape):
        c = in_shape[-1]
        params = {"scale": torch.ones(c), "bias": torch.zeros(c)}
        state = {"mean": torch.zeros(c), "var": torch.ones(c)}
        return params, state

    def apply(self, params, state, x, *, train=False, gen=None):
        reduce_dims = tuple(range(x.dim() - 1))
        if train:
            xf = x.float()
            mean = xf.mean(dim=reduce_dims)
            mean_sq = torch.square(xf).mean(dim=reduce_dims)
            if self.axis_name is not None:
                from theanompi_tpu_torch.parallel.mesh import pmean

                # two-moment form: both statistics in one collective
                both = pmean(torch.cat([mean, mean_sq]), self.axis_name)
                mean, mean_sq = both[:mean.numel()], both[mean.numel():]
            var = torch.clamp(mean_sq - torch.square(mean), min=0.0)
            m = self.momentum
            new_state = {
                "mean": m * state["mean"] + (1 - m) * mean.detach(),
                "var": m * state["var"] + (1 - m) * var.detach(),
            }
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        inv = torch.rsqrt(var + self.eps) * params["scale"]
        if x.dtype == torch.bfloat16:
            y = (x - mean.to(x.dtype)) * inv.to(x.dtype) + params["bias"].to(x.dtype)
            return y, new_state
        y = (x.float() - mean) * inv + params["bias"]
        return y.to(x.dtype), new_state


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default tanh form, op by op with its constants in
    x's dtype. In bf16 the reference rounds after every op, where
    ``F.gelu(approximate="tanh")`` computes in fp32 and rounds once: a
    different bf16 result for about a third of the inputs. The constants
    are 0-d CPU tensors, which a CUDA op takes as scalars."""

    def c(v):
        return torch.tensor(v, dtype=x.dtype)

    cdf = c(0.5) * (c(1.0) + torch.tanh(c(math.sqrt(2 / math.pi)) * (x + c(0.044715) * x ** 3)))
    return x * cdf


class Activation(Layer):
    _FNS: dict = {
        "relu": F.relu,
        "gelu": gelu,
        "tanh": torch.tanh,
        "sigmoid": torch.sigmoid,
        "identity": lambda x: x,
    }

    def __init__(self, fn: Union[str, Callable] = "relu", name: Optional[str] = None):
        self.fn = self._FNS[fn] if isinstance(fn, str) else fn
        self.name = name or (fn if isinstance(fn, str) else "act")

    def apply(self, params, state, x, *, train=False, gen=None):
        return self.fn(x), state


class Flatten(Layer):
    """Flatten NHWC to (N, H*W*C), rows in (h, w, c) order as the reference."""

    name = "flatten"

    def apply(self, params, state, x, *, train=False, gen=None):
        return x.reshape(x.shape[0], -1), state

    def out_shape(self, in_shape: Shape) -> Shape:
        return (in_shape[0], int(math.prod(in_shape[1:])))


class GlobalAvgPool(Layer):
    name = "gap"

    def apply(self, params, state, x, *, train=False, gen=None):
        return x.mean(dim=(1, 2)), state

    def out_shape(self, in_shape: Shape) -> Shape:
        return (in_shape[0], in_shape[-1])


class Sequential(Layer):
    """Composition of layers with per-layer namespaced params/state
    (keys ``f"{i:02d}_{layer.name}"``, the reference's)."""

    def __init__(self, layers: Sequence[Layer], name: str = "seq"):
        self.layers = list(layers)
        self.name = name
        self._keys = [f"{i:02d}_{l.name}" for i, l in enumerate(self.layers)]

    def init(self, gen, in_shape: Shape):
        params, state = {}, {}
        shape = in_shape
        for lname, layer in zip(self._keys, self.layers):
            if any(d <= 0 for d in shape):
                raise ValueError(
                    f"{self.name}: input to layer {lname!r} has non-positive "
                    f"dims {tuple(shape)} — input_shape too small for this "
                    "architecture"
                )
            p, s = layer.init(gen, shape)
            if p:
                params[lname] = p
            if s:
                state[lname] = s
            shape = layer.out_shape(shape)
        return params, state

    def apply(self, params, state, x, *, train=False, gen=None):
        new_state = dict(state)
        for lname, layer in zip(self._keys, self.layers):
            x, s2 = layer.apply(params.get(lname, {}), state.get(lname, {}), x,
                                train=train, gen=gen)
            if s2:
                new_state[lname] = s2
        return x, new_state

    def out_shape(self, in_shape: Shape) -> Shape:
        shape = in_shape
        for layer in self.layers:
            shape = layer.out_shape(shape)
        return shape

    def param_layouts(self, params) -> dict:
        return {lname: layer.param_layouts(params[lname])
                for lname, layer in zip(self._keys, self.layers) if lname in params}
