"""Wire codecs of the gradient exchange: block-scaled low-bit quantize
-> reduce -> dequantize, with optional error feedback.

Port of ``theanompi_tpu/parallel/codec.py`` (the pieces the BSP slice
and, later, GoSGD use). Codecs, selected by ``--wire-codec
{none,bf16,int8}[:ef]``:

- ``none``  — identity (fp32 wire);
- ``bf16``  — round-to-nearest bf16 values (2 B/elem);
- ``int8``  — per-128-element-block absmax-scaled int8 through the
  kernels of ``ops/quant.py`` (1 + 4/128 B/elem, scales included).

``:ef`` turns on error feedback: each rank keeps the residual
``r' = (v + r) - Q(v + r)`` of what its quantizer discarded and adds it
back next round, so quantization error telescopes instead of
accumulating. The reference stacks the residuals ``[n, ...]`` over the
devices of one program; here every rank is its own process and holds
its own residual tree in ``TrainState.ef``, which is that stack split
by rank. ``compress`` on a rank's own residual is therefore the
counterpart of both the reference's ``compress`` and its
``compress_stacked``.

Element order: a leaf is quantized in the reference's flat order, which
its layout tag decides (``nn.layers.to_reference_layout``: a
``CONV_KERNEL`` leaf HWIO, a ``PLAIN`` leaf of any rank as it is), so
its 128-element blocks, and with them the scales, are the reference's.
``compress`` takes the tags of the tree (``Model.param_layouts``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Union

import torch

from theanompi_tpu_torch.nn.layers import (
    PLAIN,
    from_reference_layout,
    to_reference_layout,
)
from theanompi_tpu_torch.ops.quant import (
    LANES,
    dequantize_int8_block_leaves,
    quantize_int8_block_leaves,
    wire_decode,
    wire_encode,
    wire_rows,
)
from theanompi_tpu_torch.tree import tree_leaves, tree_map

Tree = Any

# wire bytes per payload element, scale overhead included (int8: 1 B
# values + one 4 B f32 scale per 128-element block)
CODEC_WIRE_BYTES = {
    "none": 4.0,
    "bf16": 2.0,
    "int8": 1.0 + 4.0 / LANES,
}


def _qdq_int8_leaves(xs, layouts) -> list:
    """Block quantize-dequantize of f32 tensors of any shape, ``layouts``
    their tags: each flattened in the reference's order, all of them
    quantized in one kernel launch and dequantized in one (each leaf's
    tail zero-padded to a 128-element row inside the kernel), each laid
    out as its ``x`` again."""
    refs = [to_reference_layout(x, lay) for x, lay in zip(xs, layouts, strict=True)]
    flats = [r.reshape(-1) for r in refs]
    vals, scales, row0s = quantize_int8_block_leaves(flats)
    # every leaf's output starts on a row of one buffer: 512-byte aligned
    back = torch.empty(vals.shape[0] * LANES, dtype=torch.float32, device=vals.device)
    outs = [back[r0 * LANES:r0 * LANES + f.numel()] for r0, f in zip(row0s, flats)]
    dequantize_int8_block_leaves(vals, scales, outs, row0s)
    return [from_reference_layout(o.view(r.shape), lay) for o, r, lay in zip(outs, refs, layouts)]


@dataclass(frozen=True)
class WireCodec:
    """One wire codec: a value-space quantizer ``Q`` plus the
    error-feedback policy and the bytes per element it costs. Stateless;
    the residuals live in ``TrainState.ef`` and pass through
    :meth:`compress`."""

    name: str  # none | bf16 | int8
    error_feedback: bool = False

    def __post_init__(self):
        if self.name not in CODEC_WIRE_BYTES:
            raise ValueError(
                f"unknown wire codec {self.name!r}; available: "
                f"{sorted(CODEC_WIRE_BYTES)} (suffix ':ef' for error feedback)"
            )
        if self.name == "none" and self.error_feedback:
            raise ValueError(
                "'none:ef' is meaningless: the identity codec discards "
                "nothing, so there is no error to feed back"
            )

    @property
    def active(self) -> bool:
        return self.name != "none"

    @property
    def wire_bytes_per_element(self) -> float:
        return CODEC_WIRE_BYTES[self.name]

    @property
    def spec(self) -> str:
        """The CLI spelling that round-trips through :func:`get_codec`."""
        return self.name + (":ef" if self.error_feedback else "")

    def qdq(self, x: torch.Tensor, layout: str = PLAIN) -> torch.Tensor:
        """Quantize-dequantize one f32 tensor (any shape; ``layout`` its
        tag): the value the far side of the wire reconstructs."""
        if self.name == "bf16":
            return x.to(torch.bfloat16).float()
        if self.name == "int8":
            return _qdq_int8_leaves([x], [layout])[0]
        return x

    def _through(self, vs, efs, layouts) -> tuple:
        """Leaves through the active codec -> ``(wire values, residuals')``:
        with error feedback each carried residual (``efs[i]``; None without
        it) is added before quantizing, and the new one is what the
        quantizer discarded (None without error feedback). ``int8``
        quantizes every leaf in one kernel launch and dequantizes them in
        one, in the given order."""
        xs = [v.float() if r is None else v.float() + r for v, r in zip(vs, efs, strict=True)]
        qs = (_qdq_int8_leaves(xs, layouts) if self.name == "int8"
              else [self.qdq(x, lay) for x, lay in zip(xs, layouts)])
        wire = [q.to(v.dtype) for v, q in zip(vs, qs)]
        return wire, ([x - q for x, q in zip(xs, qs)] if self.error_feedback else None)

    def compress_leaf(self, v: torch.Tensor, ef: Optional[torch.Tensor],
                      layout: str = PLAIN):
        """One leaf through the codec -> ``(wire_value, residual')``: with
        error feedback the carried residual is added before quantizing
        and the new one is what the quantizer discarded; without it the
        residual passes through."""
        if not self.active:
            return v, ef
        wire, efs = self._through([v], [ef if self.error_feedback else None], [layout])
        return wire[0], (efs[0] if self.error_feedback else ef)

    def compress(self, tree: Tree, ef: Tree, layouts: Tree):
        """:meth:`compress_leaf` over the tree -> ``(wire_tree, ef')``.
        With error feedback ``ef`` is this rank's residual tree
        (:meth:`init_ef`); otherwise it passes through untouched.
        ``layouts``: the tree's layout tags (``Model.param_layouts``).
        ``int8`` quantizes every leaf in one kernel launch and
        dequantizes them in one, in the reference's leaf order."""
        if not self.active:
            return tree, ef
        leaves, lays = tree_leaves(tree), tree_leaves(layouts)
        ef_leaves = tree_leaves(ef) if self.error_feedback else [None] * len(leaves)
        if len(ef_leaves) != len(leaves):
            raise ValueError(
                f"error-feedback state has {len(ef_leaves)} leaves for a "
                f"{len(leaves)}-leaf wire tree — the engine state was not "
                "initialized with init_ef"
            )
        wire_leaves, ef_out = self._through(leaves, ef_leaves, lays)
        wire_it = iter(wire_leaves)
        wire = tree_map(lambda _: next(wire_it), tree)
        if not self.error_feedback:
            return wire, ef
        ef_it = iter(ef_out)
        return wire, tree_map(lambda _: next(ef_it), tree)

    def init_ef(self, tree: Tree) -> Tree:
        """Zero residuals for ``tree`` (f32, one per leaf, in each leaf's
        layout), or ``()`` when this codec carries no state."""
        if not (self.active and self.error_feedback):
            return ()
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), tree)


def get_codec(spec: Union[str, WireCodec, None]) -> WireCodec:
    """Resolve a ``--wire-codec`` spec (``none`` / ``bf16`` / ``int8``,
    optional ``:ef``) to a :class:`WireCodec`; instances pass through,
    ``None`` means ``none``."""
    if isinstance(spec, WireCodec):
        return spec
    if spec is None:
        return WireCodec("none")
    name, _, flag = str(spec).partition(":")
    if flag not in ("", "ef"):
        raise ValueError(f"bad wire-codec suffix {flag!r} in {spec!r} (only ':ef')")
    return WireCodec(name or "none", error_feedback=flag == "ef")


# --------------------------------------------------------------------------
# gossip payload packing (GoSGD): values compressed, the share weight
# exact — quantizing it would leak the sum(alpha) == 1 mass invariant
# --------------------------------------------------------------------------


def gossip_encode(codec: WireCodec, values: torch.Tensor, share: torch.Tensor) -> torch.Tensor:
    """One gossip message ``(flat f32 values, f32 share scalar)``.
    ``int8``: the packed wire message plus one tail row whose first 4
    bytes are the share's. ``bf16``: bf16 values with the share's bits
    as two bf16 lanes. ``none``: ``concat(values, share)`` in fp32."""
    share = share.reshape(1).float()
    if codec.name == "int8":
        packed = wire_encode(values)
        tail = packed.new_zeros((1, LANES))
        tail[0, :4] = share.view(torch.int8)
        return torch.cat([packed, tail])
    if codec.name == "bf16":
        return torch.cat([values.to(torch.bfloat16), share.view(torch.bfloat16)])
    return torch.cat([values, share])


def gossip_decode(codec: WireCodec, message: torch.Tensor, length: int):
    """Inverse of :func:`gossip_encode` -> ``(values f32 [length], share
    f32 scalar)``."""
    if codec.name == "int8":
        share = message[-1, :4].clone().view(torch.float32).reshape(())
        return wire_decode(message[:-1], length=length), share
    if codec.name == "bf16":
        share = message[-2:].clone().view(torch.float32).reshape(())
        return message[:-2].float(), share
    return message[:-1], message[-1]


def gossip_wire_bytes(codec: WireCodec, n_elements: int) -> float:
    """Per-round gossip message size in bytes, as :func:`gossip_encode`
    lays it out."""
    if codec.name == "int8":
        rows, srows = wire_rows(max(1, n_elements))
        return float((rows + srows + 1) * LANES)  # +1 share tail row
    if codec.name == "bf16":
        return float((n_elements + 2) * 2)
    return float((n_elements + 1) * 4)
