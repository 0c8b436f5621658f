"""How accurate AlexNet's fp32 convolution gradients are on the card.

    python -m theanompi_tpu_torch.tools.conv_precision [--batch 8] [--size 227]

For every ``Conv`` of AlexNet at its real channel widths (input
``size`` x ``size`` x 3), with a random ReLU'd input, weight and output
gradient made from a seed, it computes the port's ``nn.Conv`` weight
gradient (wgrad) and input gradient (dgrad) in fp32 on the card (one
cuDNN call, TF32 off as ``device.py`` sets it) and reports each one's
error against the same gradients in float64 on the CPU, as
``max |g - g64| / max |g64|``. cuDNN picks its algorithm by shape, so
run it at each geometry of interest (``--size 227``: full width;
``--size 67``: the fp32 parity run of ``chip_smoke.py``). The last stdout
line is the JSON result. Needs a card.
"""

from __future__ import annotations

import argparse
import json

import torch

from theanompi_tpu_torch.device import resolve_device
from theanompi_tpu_torch.models.alex_net import AlexNet
from theanompi_tpu_torch.nn.layers import Conv


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.double().cpu() - b).abs().max() / b.abs().max()).item()


def _grads(layer: Conv, x, w, gy, device, dtype):
    """(wgrad, dgrad) of ``layer`` at input ``x``, weight ``w`` against
    the output gradient ``gy``, on ``device`` in ``dtype``."""
    xx = x.to(device, dtype).requires_grad_(True)
    ww = w.to(device, dtype).requires_grad_(True)
    b = torch.zeros(ww.shape[0], dtype=dtype, device=device)
    y, _ = layer.apply({"w": ww, "b": b}, {}, xx)
    gw, gx = torch.autograd.grad(y, (ww, xx), gy.to(device, dtype))
    return gw, gx


def measure(batch: int = 8, size: int = 227, seed: int = 0) -> dict:
    device = resolve_device(None)
    model = AlexNet(AlexNet.default_recipe().replace(input_shape=(size, size, 3)))
    gen = torch.Generator().manual_seed(seed)
    shape = (batch, size, size, 3)
    rows = []
    for layer in model.net.layers:
        out_shape = layer.out_shape(shape)
        if isinstance(layer, Conv):
            params, _ = layer.init(gen, shape)
            x = torch.randn(shape, generator=gen, dtype=torch.float64).relu()
            w = params["w"].double()
            gy = torch.randn(out_shape, generator=gen, dtype=torch.float64)
            ref_w, ref_x = _grads(layer, x, w, gy, "cpu", torch.float64)
            gw, gx = _grads(layer, x, w, gy, device, torch.float32)
            rows.append({"name": layer.name, "in_shape": list(shape),
                         "kernel": list(layer.kernel), "stride": list(layer.stride),
                         "groups": layer.groups, "wgrad_err": _rel(gw, ref_w),
                         "dgrad_err": _rel(gx, ref_x)})
        shape = out_shape
    return {"device": torch.cuda.get_device_name(device), "batch": batch, "size": size,
            "torch": torch.__version__, "cudnn": torch.backends.cudnn.version(), "convs": rows}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=227)
    args = p.parse_args(argv)
    result = measure(batch=args.batch, size=args.size)
    for r in result["convs"]:
        print(f"{r['name']:6s} in {r['in_shape']} k{r['kernel']} s{r['stride']} "
              f"g{r['groups']}: wgrad err {r['wgrad_err']:.3g}, dgrad err {r['dgrad_err']:.3g}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
